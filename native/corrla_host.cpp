// corrla_rs_tpu native host runtime.
//
// The reference is a single Rust crate whose "runtime" is Rayon
// shared-memory threading (SURVEY.md §2.2). The rebuild's compute path is
// XLA on the GPU; this C++ module is the host-side counterpart for work that
// is a poor fit for the device:
//
//  - cs_dirichlet_rejection: multithreaded constrained-Dirichlet rejection
//    sampling (parity with space_samplers.rs:14-126). The device kernel
//    (ops/samplers.py) wins when acceptance is moderate; at pathological
//    acceptance rates (< ~1e-6) the fixed-chunk device loop burns HBM
//    bandwidth on rejected rows, while this streaming sampler costs O(1)
//    memory per thread (SURVEY.md §7 hard part 2).
//  - kdtree_build/kdtree_knn: exact kd-tree k-nearest-neighbor queries
//    (parity with the reference's kdtree crate usage,
//    active_subspaces.rs:71-112). The on-device kNN is O(N^2) distances;
//    the kd-tree is the host path for very large point clouds at low
//    dimension (SURVEY.md §7 hard part 5).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -march=native -fPIC -shared)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// RNG: xoshiro256++ (public-domain algorithm), one stream per thread.
// ---------------------------------------------------------------------
struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() {  // (0, 1)
    return ((next() >> 11) + 0.5) * (1.0 / 9007199254740992.0);
  }
  inline double normal() {  // Box-Muller (one value; wasteful but simple)
    double u1 = uniform(), u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }
  // Marsaglia-Tsang gamma sampler (alpha >= 1); boost trick for alpha < 1.
  double gamma(double alpha) {
    if (alpha < 1.0) {
      double u = uniform();
      return gamma(alpha + 1.0) * std::pow(u, 1.0 / alpha);
    }
    const double d = alpha - 1.0 / 3.0;
    const double c = 1.0 / std::sqrt(9.0 * d);
    for (;;) {
      double x, v;
      do {
        x = normal();
        v = 1.0 + c * x;
      } while (v <= 0.0);
      v = v * v * v;
      double u = uniform();
      if (u < 1.0 - 0.0331 * x * x * x * x) return d * v;
      if (std::log(u) < 0.5 * x * x + d * (1.0 - v + std::log(v)))
        return d * v;
    }
  }
};

}  // namespace

extern "C" {

// Multithreaded constrained-Dirichlet rejection sampling.
// bounds: (ndim, 2) row-major [lb, ub]; alphas: (ndim);
// out: (n_samples, ndim) row-major. Returns number of valid samples
// produced (== n_samples on success; < n_samples if the per-thread shot
// budget ran out).
int64_t cs_dirichlet_rejection(const double* bounds, const double* alphas,
                               int64_t ndim, int64_t n_samples,
                               int64_t max_zshots, int64_t chunk_size,
                               double c_scale, uint64_t seed,
                               int64_t n_threads, double* out) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_samples, 1));
  std::atomic<int64_t> next_slot(0);

  auto worker = [&](int t) {
    Xoshiro256 rng(seed * 0x9e3779b97f4a7c15ULL + 0x7f4a7c15ULL * (t + 1));
    std::vector<double> x(ndim);
    // budget mirrors the reference semantics: max_zshots chunks of
    // chunk_size draws, shared across the team
    int64_t budget = (max_zshots * chunk_size) / n_threads;
    while (budget-- > 0) {
      // Dirichlet draw via normalized gammas; Gamma(1) == Exponential,
      // which needs one log instead of the Marsaglia-Tsang loop
      double total = 0.0;
      for (int64_t j = 0; j < ndim; ++j) {
        x[j] = alphas[j] == 1.0 ? -std::log(rng.uniform())
                                : rng.gamma(alphas[j]);
        total += x[j];
      }
      bool ok = total > 0.0;
      for (int64_t j = 0; ok && j < ndim; ++j) {
        x[j] = x[j] / total * c_scale;
        ok = (bounds[2 * j] <= x[j]) && (x[j] <= bounds[2 * j + 1]);
      }
      if (!ok) continue;
      int64_t slot = next_slot.fetch_add(1);
      if (slot >= n_samples) return;
      std::memcpy(out + slot * ndim, x.data(), ndim * sizeof(double));
    }
  };

  std::vector<std::thread> team;
  for (int t = 0; t < n_threads; ++t) team.emplace_back(worker, t);
  for (auto& th : team) th.join();
  int64_t produced = next_slot.load();
  return produced < n_samples ? produced : n_samples;
}

// ---------------------------------------------------------------------
// kd-tree
// ---------------------------------------------------------------------
struct KdTree {
  // implicit median-split tree over index array
  const double* pts;  // (n, d) row-major, borrowed
  int64_t n, d;
  std::vector<int64_t> idx;    // permutation, tree laid out by recursion
  std::vector<int64_t> left, right, axis;
  std::vector<double> split;
  std::vector<int64_t> node_start, node_count;  // leaf buckets
  static constexpr int64_t kLeaf = 16;
  int64_t root = -1;

  int64_t build(int64_t lo, int64_t hi, int depth) {
    int64_t node = static_cast<int64_t>(left.size());
    left.push_back(-1);
    right.push_back(-1);
    axis.push_back(-1);
    split.push_back(0.0);
    node_start.push_back(lo);
    node_count.push_back(hi - lo);
    if (hi - lo <= kLeaf) return node;
    // pick widest-spread axis
    int64_t ax = 0;
    double best_spread = -1.0;
    for (int64_t a = 0; a < d; ++a) {
      double mn = 1e300, mx = -1e300;
      for (int64_t i = lo; i < hi; ++i) {
        double v = pts[idx[i] * d + a];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
      }
      if (mx - mn > best_spread) {
        best_spread = mx - mn;
        ax = a;
      }
    }
    int64_t mid = (lo + hi) / 2;
    std::nth_element(
        idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
        [&](int64_t a, int64_t b) { return pts[a * d + ax] < pts[b * d + ax]; });
    axis[node] = ax;
    split[node] = pts[idx[mid] * d + ax];
    node_count[node] = 0;  // interior
    int64_t l = build(lo, mid, depth + 1);
    int64_t r = build(mid, hi, depth + 1);
    left[node] = l;
    right[node] = r;
    return node;
  }

  void query(const double* q, int64_t k,
             std::priority_queue<std::pair<double, int64_t>>& best,
             int64_t node) const {
    if (node_count[node] > 0 || left[node] < 0) {  // leaf
      for (int64_t i = node_start[node];
           i < node_start[node] + node_count[node]; ++i) {
        double d2 = 0.0;
        const double* p = pts + idx[i] * d;
        for (int64_t a = 0; a < d; ++a) {
          double diff = q[a] - p[a];
          d2 += diff * diff;
        }
        if (static_cast<int64_t>(best.size()) < k)
          best.emplace(d2, idx[i]);
        else if (d2 < best.top().first) {
          best.pop();
          best.emplace(d2, idx[i]);
        }
      }
      return;
    }
    int64_t ax = axis[node];
    double diff = q[ax] - split[node];
    int64_t near = diff <= 0.0 ? left[node] : right[node];
    int64_t far = diff <= 0.0 ? right[node] : left[node];
    query(q, k, best, near);
    if (static_cast<int64_t>(best.size()) < k ||
        diff * diff < best.top().first)
      query(q, k, best, far);
  }
};

void* kdtree_build(const double* pts, int64_t n, int64_t d) {
  auto* t = new KdTree();
  t->pts = pts;
  t->n = n;
  t->d = d;
  t->idx.resize(n);
  std::iota(t->idx.begin(), t->idx.end(), 0);
  t->root = t->build(0, n, 0);
  return t;
}

void kdtree_free(void* tree) { delete static_cast<KdTree*>(tree); }

// queries: (m, d); out_idx: (m, k); out_dist: (m, k) — sorted ascending.
void kdtree_knn(void* tree, const double* queries, int64_t m, int64_t k,
                int64_t n_threads, int64_t* out_idx, double* out_dist) {
  auto* t = static_cast<KdTree*>(tree);
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= m) return;
      std::priority_queue<std::pair<double, int64_t>> best;
      t->query(queries + i * t->d, k, best, t->root);
      int64_t got = static_cast<int64_t>(best.size());
      for (int64_t j = got - 1; j >= 0; --j) {
        out_dist[i * k + j] = std::sqrt(best.top().first);
        out_idx[i * k + j] = best.top().second;
        best.pop();
      }
      for (int64_t j = got; j < k; ++j) {  // n < k corner
        out_idx[i * k + j] = -1;
        out_dist[i * k + j] = -1.0;
      }
    }
  };
  std::vector<std::thread> team;
  for (int64_t t2 = 0; t2 < n_threads; ++t2) team.emplace_back(worker);
  for (auto& th : team) th.join();
}

// ---------------------------------------------------------------------
// DEMC MCMC with a constrained-Dirichlet target: the compiled
// reference-class competitor for cs_mcmc_dirichlet_sample (the reference
// runs this exact pipeline as a Rayon loop, space_samplers.rs:252-418 +
// lib_math_utils_py.rs:107-168). api.cs_mcmc_dirichlet_sample runs it
// for small chain populations.
//
// Semantics mirror the reference: per generation, every chain proposes
// x' = x + gamma*(x_a - x_b) + U(0, eps) from two distinct OTHER chains
// of the PREVIOUS generation (parallel-update semantics, like
// sample_mcmc_par), the proposal is renormalized onto the c_scale
// simplex (the fixup closure), and Metropolis-accepted under
// ln Dirichlet(alpha) + uniform box prior.
// chains: (n_chains, ndim) in/out; out: (n_steps * n_chains, ndim)
// round-robin interleaved like the reference's get_samples. Returns the
// acceptance ratio.
double demc_dirichlet(const double* bounds, const double* alphas,
                      int64_t ndim, double* chains, int64_t n_chains,
                      int64_t n_steps, double gamma, double var_epsilon,
                      double c_scale, uint64_t seed, double* out) {
  auto lnprob = [&](const double* x) -> double {
    double total = 0.0;
    for (int64_t j = 0; j < ndim; ++j) {
      if (x[j] < bounds[2 * j] || x[j] > bounds[2 * j + 1])
        return -1e300;  // outside the box prior
      total += x[j];
    }
    // Dirichlet lnpdf of x normalized onto the unit simplex
    double lp = 0.0, a_sum = 0.0;
    for (int64_t j = 0; j < ndim; ++j) {
      double u = x[j] / total;
      if (u <= 0.0) return -1e300;
      lp += (alphas[j] - 1.0) * std::log(u) - std::lgamma(alphas[j]);
      a_sum += alphas[j];
    }
    return lp + std::lgamma(a_sum);
  };

  Xoshiro256 rng(seed);
  std::vector<double> lnp(n_chains), prev(n_chains * ndim);
  std::vector<double> prop(ndim);
  for (int64_t c = 0; c < n_chains; ++c) lnp[c] = lnprob(chains + c * ndim);
  int64_t accepted = 0;
  for (int64_t s = 0; s < n_steps; ++s) {
    std::memcpy(prev.data(), chains, n_chains * ndim * sizeof(double));
    for (int64_t c = 0; c < n_chains; ++c) {
      // two distinct other chains from the previous generation
      int64_t a = static_cast<int64_t>(rng.next() % (n_chains - 1));
      if (a >= c) ++a;
      int64_t b = static_cast<int64_t>(rng.next() % (n_chains - 2));
      if (b >= std::min(a, c)) ++b;
      if (b >= std::max(a, c)) ++b;
      double total = 0.0;
      for (int64_t j = 0; j < ndim; ++j) {
        prop[j] = prev[c * ndim + j] +
                  gamma * (prev[a * ndim + j] - prev[b * ndim + j]) +
                  var_epsilon * rng.uniform();
        total += prop[j];
      }
      if (total > 0.0)  // simplex-renormalizing fixup
        for (int64_t j = 0; j < ndim; ++j) prop[j] *= c_scale / total;
      double lp_new = lnprob(prop.data());
      if (std::log(rng.uniform()) < lp_new - lnp[c]) {
        std::memcpy(chains + c * ndim, prop.data(), ndim * sizeof(double));
        lnp[c] = lp_new;
        ++accepted;
      }
      std::memcpy(out + (s * n_chains + c) * ndim, chains + c * ndim,
                  ndim * sizeof(double));
    }
  }
  return static_cast<double>(accepted) /
         static_cast<double>(n_steps * n_chains);
}

// Kendall's tau via Knight's O(n log n) algorithm (Knight 1966): sort by
// (x, y), count x-tie and joint-tie pairs, then count swaps (discordant
// pairs) as merge-sort inversions of the y sequence, and y-tie pairs from
// the y-sorted sequence. Returns tau-b numerator / n0 with the tau-a
// denominator n0 = n(n-1)/2 — identical to the device O(n^2)
// sign-product mean for tie-free data, and its natural tie-aware
// extension otherwise.
static int64_t merge_count(std::vector<double>& a, std::vector<double>& buf,
                           int64_t lo, int64_t hi) {
  if (hi - lo < 2) return 0;
  int64_t mid = (lo + hi) / 2;
  int64_t inv = merge_count(a, buf, lo, mid) + merge_count(a, buf, mid, hi);
  int64_t i = lo, j = mid, k = lo;
  while (i < mid && j < hi) {
    if (a[j] < a[i]) {   // strict: equal keys are NOT inversions
      buf[k++] = a[j++];
      inv += mid - i;
    } else {
      buf[k++] = a[i++];
    }
  }
  while (i < mid) buf[k++] = a[i++];
  while (j < hi) buf[k++] = a[j++];
  std::copy(buf.begin() + lo, buf.begin() + hi, a.begin() + lo);
  return inv;
}

double kendall_tau_knight(const double* x, const double* y, int64_t n) {
  if (n < 2) return 0.0;
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    if (x[a] != x[b]) return x[a] < x[b];
    return y[a] < y[b];
  });
  // tie counts over the (x, y)-sorted order
  int64_t n1 = 0, n3 = 0;
  {
    int64_t tx = 1, txy = 1;
    for (int64_t i = 1; i < n; ++i) {
      bool same_x = x[idx[i]] == x[idx[i - 1]];
      bool same_xy = same_x && y[idx[i]] == y[idx[i - 1]];
      if (same_x) {
        ++tx;
      } else {
        n1 += tx * (tx - 1) / 2;
        tx = 1;
      }
      if (same_xy) {
        ++txy;
      } else {
        n3 += txy * (txy - 1) / 2;
        txy = 1;
      }
    }
    n1 += tx * (tx - 1) / 2;
    n3 += txy * (txy - 1) / 2;
  }
  std::vector<double> ys(n), buf(n);
  for (int64_t i = 0; i < n; ++i) ys[i] = y[idx[i]];
  int64_t swaps = merge_count(ys, buf, 0, n);  // ys ends up sorted
  int64_t n2 = 0;
  {
    int64_t ty = 1;
    for (int64_t i = 1; i < n; ++i) {
      if (ys[i] == ys[i - 1]) {
        ++ty;
      } else {
        n2 += ty * (ty - 1) / 2;
        ty = 1;
      }
    }
    n2 += ty * (ty - 1) / 2;
  }
  const double n0 = 0.5 * static_cast<double>(n) * (n - 1);
  const double s = n0 - n1 - n2 + n3 - 2.0 * static_cast<double>(swaps);
  return s / n0;
}

}  // extern "C"
