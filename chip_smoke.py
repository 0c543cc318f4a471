"""Run the library's main path once on the GPU and check every result.

Each phase calls the public entry points at the sizes of the repo's own
benchmarks and compares what comes out with a plain float64 reference that
shares no code with the library (numpy, or a plain jnp loop under
``jax.enable_x64``). A phase prints one line per check: its error, its
tolerance and the reason for it, the platform its outputs are on, and the
wall time of a first call (with compilation) and a second call.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the sharded phases only

The last line of standard output is ``{"ok": true, "device": {...}}`` and
is printed only when every check met its tolerance with its outputs on the
GPU. Without a GPU the script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    # rsvd / single_pass (bench.py's headline shape)
    rows: int = 100_000
    cols: int = 10_000
    rank: int = 100
    n_iter: int = 8
    n_os: int = 10
    planted_rank: int = 150
    # dream (bench.py's DREAM cell)
    dream_chains: int = 8192
    dream_steps: int = 500
    # dirichlet
    rej_samples: int = 3000
    rej_chunk: int = 1_000_000
    demc_chains: int = 4096
    demc_samples: int = 3000
    # dmd
    ens_members: int = 16
    ens_nx: int = 20
    ens_nt: int = 40
    dmd_points: int = 100_000
    dmd_snaps: int = 200
    # rom
    pca_rows: int = 1_000_000
    pca_cols: int = 64
    pod_points: int = 20_000
    pod_snaps: int = 200
    rbf_points: int = 8_000
    rbf_queries: int = 2_000
    as_points: int = 20_000
    as_dim: int = 10
    # --cards 4
    sharded_rows: int = 400_000
    sharded_chains: int = 32_768


FULL = Sizes()
# Small enough for the CPU: the same phases and checks, used by the tests.
TINY = Sizes(
    rows=10_000, cols=1_000,
    dream_chains=1024, dream_steps=400,
    rej_samples=300, rej_chunk=200_000, demc_chains=600, demc_samples=300,
    ens_members=4, dmd_points=2_000,
    pca_rows=20_000, pod_points=2_000, rbf_points=600, rbf_queries=200,
    as_points=1_500, sharded_rows=8_000, sharded_chains=1_024,
)

DIRICHLET_BOUNDS = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])


class SmokeFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def platforms(tree) -> set:
    import jax

    found = set()
    for leaf in jax.tree.leaves(tree):
        if isinstance(leaf, jax.Array):
            found |= {d.platform for d in leaf.devices()}
    return found


def twice(fn, arrays=lambda out: out):
    """(result, first wall, second wall). Each call ends when the arrays
    that ``arrays(result)`` picks out are ready on the device."""
    import jax

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(arrays(out))
        walls.append(time.perf_counter() - t0)
    return out, walls[0], walls[1]


def check(phase, name, err, tol, reason, outputs, walls, expect):
    """Print one check line; raise SmokeFailure if it missed."""
    plats = platforms(outputs)
    err = float(err)
    print(
        f"[{phase}] {name}: err={err:.3e} tol={tol:.1e} ({reason}) "
        f"platform={','.join(sorted(plats)) or 'none'} "
        f"first={walls[0]:.3f}s second={walls[1]:.3f}s",
        flush=True,
    )
    if not err < tol:
        raise SmokeFailure(f"{phase}/{name}: error {err:.3e} >= {tol:.1e}")
    if plats != {expect}:
        raise SmokeFailure(
            f"{phase}/{name}: outputs on {sorted(plats)}, expected {expect}")


def note(phase, text):
    print(f"[{phase}] {text}", flush=True)


# ---------------------------------------------------------------------------
# float64 references (no library code)
# ---------------------------------------------------------------------------

def rsvd_reference_f64(a, omega, n_iter: int) -> np.ndarray:
    """Singular values of examples/benchmark_rsvd.py's randomized SVD in
    float64, with a Householder QR before every power step."""
    import jax
    import jax.numpy as jnp

    def run(a, omega):
        y = a @ omega
        for _ in range(n_iter):
            y = jnp.linalg.qr(y)[0]
            y = a @ (a.T @ y)
        q = jnp.linalg.qr(y)[0]
        return jnp.linalg.svd(q.T @ a, compute_uv=False)

    with jax.enable_x64(True):
        s = jax.jit(run)(jnp.asarray(a, jnp.float64),
                         jnp.asarray(omega, jnp.float64))
        return np.asarray(s)


def planted_matrix(key, rows, cols, sigma):
    """(rows, cols) float32 matrix with singular values ``sigma``, built in
    float64 as examples/benchmark_streaming.py builds its block."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        k1, k2 = jax.random.split(key)
        r = len(sigma)
        ql = jnp.linalg.qr(jax.random.normal(k1, (rows, r), jnp.float64))[0]
        qr = jnp.linalg.qr(jax.random.normal(k2, (cols, r), jnp.float64))[0]
        a = ((ql * jnp.asarray(sigma)[None, :]) @ qr.T).astype(jnp.float32)
    return a


def single_pass_tolerance(sigma, k, ell) -> float:
    """Absolute bound on every singular value of the two-sided sketch.

    Tropp, Yurtsever, Udell & Cevher (SIMAX 2017), Thm 4.3:
    E||A - QX||_F^2 <= (1 + f(k, l)) min_{r < k-1} (1 + f(r, k)) tail_r^2
    with f(s, t) = s / (t - s - 1). Weyl bounds each |sigma_i(QX) -
    sigma_i(A)| by ||A - QX||_2 <= ||A - QX||_F; the factor 3 makes a
    miss a 1-in-9 event at worst (Markov on the squared error).
    """
    s2 = np.asarray(sigma, np.float64) ** 2
    best = min(
        (1.0 + r / (k - r - 1)) * s2[r:].sum() for r in range(0, k - 1)
    )
    return 3.0 * math.sqrt((1.0 + k / (ell - k - 1)) * best)


def dmdc_eigs_f64(x, u, p: int, r: int) -> np.ndarray:
    """DMDc eigenvalues (Proctor, Brunton & Kutz 2016, eqs. 29 and 36) in
    numpy float64: input space truncated to p, output space to r."""
    x = np.asarray(x, np.float64)
    u = np.asarray(u, np.float64)
    n_x = x.shape[0]
    x_in = np.vstack([x, u])[:, :-1]
    y = x[:, 1:]
    ut, st, vt = np.linalg.svd(x_in, full_matrices=False)
    ut, st, v = ut[:, :p], st[:p], vt[:p].T
    uh = np.linalg.svd(y, full_matrices=False)[0][:, :r]
    a_til = uh.T @ y @ v @ np.diag(1.0 / st) @ ut[:n_x].T @ uh
    return np.linalg.eigvals(a_til)


def match_eigs(ref, got) -> float:
    """Largest distance after pairing each reference eigenvalue with its
    own fitted eigenvalue (optimal assignment)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(np.asarray(ref)[:, None] - np.asarray(got)[None, :])
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].max())


def subspace_sin(a, b) -> float:
    """Sine of the largest principal angle between two column spaces."""
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    c = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - c.min() ** 2)))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_rsvd(sz: Sizes, expect: str):
    import jax
    import jax.numpy as jnp
    from jax import lax

    import bench
    from corrla_rs_tpu import api
    from corrla_rs_tpu.ops.random_svd import random_svd

    a = jax.block_until_ready(
        jax.random.normal(jax.random.key(0), (sz.rows, sz.cols), jnp.float32))
    key = jax.random.key(7)
    k = sz.rank + sz.n_os
    omega = jax.random.normal(key, (sz.cols, k), jnp.float32)
    s_ref = rsvd_reference_f64(a, omega, sz.n_iter)[: sz.rank]
    note("rsvd", f"matrix {sz.rows}x{sz.cols} f32 "
                 f"({a.size * 4 / 1e9:.2f} GB), rank {sz.rank}, "
                 f"{sz.n_iter} iters, {sz.n_os} oversamples, key 7")

    bench_prec = bench.HEADLINE_KW["power_precision"]
    for prec in (lax.Precision.HIGH, lax.Precision.HIGHEST):
        kw = dict(bench.HEADLINE_KW, power_precision=prec)
        if prec == bench_prec:
            mem = random_svd.lower(
                a, sz.rank, sz.n_iter, sz.n_os, key=key, **kw
            ).compile().memory_analysis()
            note("rsvd", "headline memory_analysis: " + ", ".join(
                f"{f}={getattr(mem, f, None)}" for f in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes")))
        out, t1, t2 = twice(lambda: random_svd(
            a, sz.rank, sz.n_iter, sz.n_os, key=key, **kw))
        err = np.max(np.abs(np.asarray(out[1], np.float64) - s_ref) / s_ref)
        used = prec == bench_prec
        name = f"random_svd power_precision={prec.name}" + (
            " (bench.py's setting)" if used else " (not bench.py's setting)")
        if used:
            check("rsvd", name, err, 1e-6,
                  "max rel sigma error vs float64 on the same Omega; the "
                  "repo's stated target", out, (t1, t2), expect)
        else:
            note("rsvd", f"{name}: err={err:.3e} (informational, "
                         f"first={t1:.3f}s second={t2:.3f}s, "
                         f"platform={','.join(sorted(platforms(out)))})")

    out, t1, t2 = twice(lambda: api.rsvd(a, sz.rank, sz.n_iter, sz.n_os, 7))
    err = np.max(np.abs(np.asarray(out[1][:, 0], np.float64) - s_ref) / s_ref)
    check("rsvd", "api.rsvd (defaults: HIGHEST)", err, 1e-6,
          "max rel sigma error vs float64 on the same Omega", out, (t1, t2),
          expect)


def phase_single_pass(sz: Sizes, expect: str):
    import jax

    from corrla_rs_tpu.ops.random_svd import single_pass_svd

    sigma = 100.0 / np.arange(1, sz.planted_rank + 1, dtype=np.float64)
    a = jax.block_until_ready(
        planted_matrix(jax.random.key(11), sz.rows, sz.cols, sigma))
    k = sz.rank + sz.n_os
    ell = min(2 * k + 1, sz.rows)
    out, t1, t2 = twice(lambda: single_pass_svd(a, sz.rank, sz.n_os, key=4))
    err = np.max(np.abs(np.asarray(out[1], np.float64) - sigma[: sz.rank]))
    tol = single_pass_tolerance(sigma, k, ell)
    note("single_pass", f"planted sigma_k = 100/k, k <= {sz.planted_rank}; "
                        f"sketch k={k}, l={ell}")
    check("single_pass", "max abs sigma error vs planted", err, tol,
          "Weyl + Tropp et al. 2017 Thm 4.3 expected-error bound, x3", out,
          (t1, t2), expect)


def phase_dream(sz: Sizes, expect: str):
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.dream import dream_run

    def lnp(x):
        return -0.5 * jnp.sum(x * x)

    heads0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((sz.dream_chains, 3)),
        jnp.float32)
    out, t1, t2 = twice(lambda: dream_run(heads0, lnp, sz.dream_steps,
                                          key=1)[0])
    tail = np.asarray(out[sz.dream_steps // 2:], np.float64).reshape(-1, 3)
    mean_err = np.max(np.abs(tail.mean(axis=0)))
    var_err = np.max(np.abs(tail.var(axis=0) - 1.0))
    note("dream", f"{sz.dream_chains} chains x 3 dims x {sz.dream_steps} "
                  f"generations, standard-normal target")
    check("dream", "pooled mean (2nd half)", mean_err, 0.05,
          "target mean 0; bar set by the issue", out, (t1, t2), expect)
    check("dream", "pooled variance - 1 (2nd half)", var_err, 0.05,
          "target variance 1, within 5%", out, (t1, t2), expect)


def _dirichlet_checks(phase, name, samples, c_scale, walls, expect):
    x = np.asarray(samples, np.float64)
    sum_err = np.max(np.abs(x.sum(axis=1) - c_scale))
    lo, hi = DIRICHLET_BOUNDS[:, 0], DIRICHLET_BOUNDS[:, 1]
    outside = np.max(np.maximum(lo[None, :] - x, x - hi[None, :]).clip(0.0))
    check(phase, f"{name}: max |sum - c_scale|", sum_err, 1e-6,
          "simplex constraint; f32 rounding of a 3-term sum", samples,
          walls, expect)
    check(phase, f"{name}: max bound violation", outside, 1e-12,
          "every sample inside the box", samples, walls, expect)


def phase_dirichlet(sz: Sizes, expect: str):
    from corrla_rs_tpu import api, native
    from corrla_rs_tpu.utils import smallpath

    b = DIRICHLET_BOUNDS
    out, t1, t2 = twice(lambda: api.cs_dirichlet_sample(
        b, sz.rej_samples, 500, sz.rej_chunk, 1.0, 0.6, seed=7))
    note("dirichlet", f"rejection: {sz.rej_samples} samples, chunk "
                      f"{sz.rej_chunk}")
    _dirichlet_checks("dirichlet", "cs_dirichlet_sample", out, 1.0,
                      (t1, t2), expect)

    out, t1, t2 = twice(lambda: api.cs_mcmc_dirichlet_sample(
        b, sz.demc_samples, sz.demc_chains, 500, sz.rej_chunk, 1.0, 0.6,
        0.8, 1e-12, seed=7))
    samples, ar = out
    note("dirichlet", f"DEMC: {sz.demc_chains} seed chains x "
                      f"{sz.demc_samples} samples, acceptance {ar:.4f}")
    _dirichlet_checks("dirichlet", "cs_mcmc_dirichlet_sample", samples, 1.0,
                      (t1, t2), expect)
    check("dirichlet", "acceptance rate outside (0, 1)",
          0.0 if 0.0 < ar < 1.0 else 1.0, 0.5, "DEMC must accept some and "
          "reject some proposals", samples, (t1, t2), expect)

    # the reference's own size: 12 chains x 3000 samples
    t0 = time.perf_counter()
    small, ar = api.cs_mcmc_dirichlet_sample(
        b, 3000, 12, 500, 10_000, 1.0, 0.6, 0.8, 1e-12, seed=7)
    wall = time.perf_counter() - t0
    plats = platforms(small)
    path = (f"device ({','.join(sorted(plats))})" if plats
            else "C++ host pipeline (native.demc_dirichlet_host)")
    note("dirichlet", f"reference size 12 chains x 3000 samples takes the "
                      f"{path}; SAMPLER_CHAINS={smallpath.SAMPLER_CHAINS}, "
                      f"routing threshold={smallpath.small_path_threshold()}, "
                      f"native available={native.available()}; "
                      f"acceptance {ar:.4f}; wall {wall:.3f}s")


def _planted_dmdc(n_x, n_t, seed):
    """x_{t+1} = A x_t + B u_t with 10 planted modes (5 complex pairs) on a
    random orthonormal basis; one random control input."""
    rng = np.random.default_rng(seed)
    rad = np.linspace(0.90, 0.99, 5)
    ang = np.linspace(0.1, 1.2, 5)
    lam = np.zeros((10, 10))
    for i, (r_, t_) in enumerate(zip(rad, ang)):
        c, s = r_ * np.cos(t_), r_ * np.sin(t_)
        lam[2 * i:2 * i + 2, 2 * i:2 * i + 2] = [[c, -s], [s, c]]
    b = rng.standard_normal((10, 1))
    u = rng.standard_normal((1, n_t))
    z = np.zeros((10, n_t))
    z[:, 0] = rng.standard_normal(10)
    for t in range(n_t - 1):
        z[:, t + 1] = lam @ z[:, t] + b[:, 0] * u[0, t]
    phi = np.linalg.qr(rng.standard_normal((n_x, 10)))[0]
    return (phi @ z).astype(np.float32), u.astype(np.float32)


def phase_dmd(sz: Sizes, expect: str):
    import jax.numpy as jnp

    from corrla_rs_tpu.models.dmd import DMDc, dmdc_fit_ensemble
    from corrla_rs_tpu.ops.eig import jittable_eig_supported

    ok = jittable_eig_supported()
    note("dmd", f"jittable_eig_supported() = {ok}")
    if not ok:
        raise SmokeFailure("jittable_eig_supported() is False on this device")

    # bench.py's ensemble: 16 members of a 20 x 40 forced-sine family
    n_mem, nx, nt = sz.ens_members, sz.ens_nx, sz.ens_nt
    t = np.linspace(0.0, 1.0, nt, dtype=np.float32)
    uc = np.exp(t)[None, :]
    snap = np.sin(np.linspace(0, 3, nx, dtype=np.float32)[:, None]
                  + t[None, :]) * uc
    scale = 1.0 + 1e-3 * np.arange(n_mem, dtype=np.float32)[:, None, None]
    ens = (np.broadcast_to(snap, (n_mem, nx, nt)) * scale).astype(np.float32)
    u_b = np.broadcast_to(uc, (n_mem,) + uc.shape).astype(np.float32)
    ens_d, u_d = jnp.asarray(ens), jnp.asarray(u_b)
    out, t1, t2 = twice(lambda: dmdc_fit_ensemble(ens_d, u_d, n_modes=6,
                                                  n_iters=20, key=2))
    lam = np.asarray(out["lambdas_re"]) + 1j * np.asarray(out["lambdas_im"])
    # the family spans 2 state and 3 input directions; the other modes of
    # the 6-mode fit carry f32 noise and have no float64 counterpart
    err = max(match_eigs(dmdc_eigs_f64(ens[i], u_b[i], 3, 2), lam[i])
              for i in range(n_mem))
    check("dmd", f"dmdc_fit_ensemble {n_mem} x {nx}x{nt}: eigenvalue error "
                 "per member", err, 1e-4,
          "f32 randomized fit vs float64 DMDc on the 2 determined modes",
          out, (t1, t2), expect)

    # a large planted-mode family: 10 state modes + 1 control
    x, u = _planted_dmdc(sz.dmd_points, sz.dmd_snaps, seed=3)
    ref = dmdc_eigs_f64(x, u, 11, 11)
    xd, ud = jnp.asarray(x), jnp.asarray(u)
    for backend in ("host", "device"):
        fit, t1, t2 = twice(
            lambda: DMDc(xd, ud, 11, 8, key=5, eig_backend=backend),
            lambda f: (f.modes_re, f.modes_im, f._w_re, f._w_im))
        err = match_eigs(ref, fit.lambdas)
        check("dmd", f"DMDc {sz.dmd_points}x{sz.dmd_snaps} "
                     f"eig_backend={backend}: eigenvalue error", err, 1e-4,
              "f32 fit vs float64 DMDc, 10 planted modes + 1 null",
              (fit.modes_re, fit.modes_im), (t1, t2), expect)


def phase_rom(sz: Sizes, expect: str):
    import jax.numpy as jnp

    from corrla_rs_tpu import api
    from corrla_rs_tpu.models.pod import PodI
    from corrla_rs_tpu.ops.interp import RbfInterp

    rng = np.random.default_rng(5)

    # rpca: planted 8-component data + isotropic noise
    n, d, r = sz.pca_rows, sz.pca_cols, 8
    basis = np.linalg.qr(rng.standard_normal((d, r)))[0]
    scales = np.array([10.0, 8.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.5])
    x = (rng.standard_normal((n, r)) * scales) @ basis.T
    x = (x + 0.05 * rng.standard_normal((n, d)) + 3.0).astype(np.float32)
    xd = jnp.asarray(x)
    out, t1, t2 = twice(lambda: api.rpca(xd, r))
    x64 = x.astype(np.float64)
    xc = x64 - x64.mean(axis=0)
    w, v = np.linalg.eigh(xc.T @ xc / (n - 1))
    s_ref = np.sqrt(w[::-1][:r] * (n - 1))
    err = np.max(np.abs(np.asarray(out[0][:, 0], np.float64) - s_ref) / s_ref)
    check("rom", f"api.rpca {n}x{d}: max rel sigma error", err, 1e-5,
          "float64 covariance eigh; f32 centring and sums over "
          f"{n} rows", out, (t1, t2), expect)
    sin = subspace_sin(np.asarray(out[1]).T, v[:, ::-1][:, :r])
    check("rom", "api.rpca: components subspace sin", sin, 1e-4,
          "float64 covariance eigenvectors; gap sigma_8/sigma_9 ~ 30",
          out, (t1, t2), expect)

    # PyPodI: rank-8 snapshot family (rows = snapshots)
    n_pts, n_snap, r = sz.pod_points, sz.pod_snaps, 8
    tt = np.linspace(0.0, 1.0, n_snap)
    grid = np.linspace(0.0, 1.0, n_pts)
    snaps = sum(
        (0.7 ** i) * np.cos((i + 1) * np.pi * tt)[:, None]
        * np.sin((i + 1) * np.pi * grid)[None, :]
        for i in range(r))
    xs = snaps.astype(np.float32)
    td = jnp.asarray(tt[:, None], jnp.float32)
    xsd = jnp.asarray(xs)
    pod, t1, t2 = twice(lambda: PodI(xsd, td, r, key=1),
                        lambda p: (p.modes, p.mode_weights, p._rbf_coeffs))
    vt_ref = np.linalg.svd(snaps, full_matrices=False)[2][:r].T
    sin = subspace_sin(np.asarray(pod.modes), vt_ref)
    check("rom", f"PodI {n_pts} points x {n_snap} snapshots: mode subspace "
                 "sin", sin, 1e-4,
          "float64 snapshot SVD of an exactly rank-8 family; f32 modes",
          (pod.modes, pod.mode_weights), (t1, t2), expect)

    # PyRbfInterp: multiquadric, d = 3
    xk = rng.uniform(0.0, 1.0, (sz.rbf_points, 3))
    yk = np.sin(3.0 * xk[:, 0]) + np.cos(2.0 * xk[:, 1]) * xk[:, 2]
    xq = rng.uniform(0.0, 1.0, (sz.rbf_queries, 3))
    eps = 3.0
    xkd, ykd = jnp.asarray(xk, jnp.float32), jnp.asarray(yk, jnp.float32)
    xqd = jnp.asarray(xq, jnp.float32)

    def rbf():
        return RbfInterp(2, eps, 3, 1).fit(xkd, ykd).predict(xqd)

    pred, t1, t2 = twice(rbf)
    # float64 saddle system [[K, P], [P^T, 0]] with P = [1, x]
    xk32 = xk.astype(np.float32).astype(np.float64)
    xq32 = xq.astype(np.float32).astype(np.float64)

    def kmat(a, b):
        dist = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
        return np.sqrt(1.0 + (eps * dist) ** 2)

    pk = np.hstack([np.ones((len(xk32), 1)), xk32])
    sys_mat = np.block([[kmat(xk32, xk32), pk],
                        [pk.T, np.zeros((4, 4))]])
    rhs = np.concatenate([yk.astype(np.float32).astype(np.float64),
                          np.zeros(4)])
    coef = np.linalg.solve(sys_mat, rhs)
    pq = np.hstack([np.ones((len(xq32), 1)), xq32])
    p_ref = np.hstack([kmat(xq32, xk32), pq]) @ coef
    p_got = np.asarray(pred, np.float64).reshape(-1)
    err = np.max(np.abs(p_got - p_ref)) / np.max(np.abs(p_ref))
    check("rom", f"RbfInterp multiquadric {sz.rbf_points} points: predict "
                 "rel error", err, 5e-2,
          "float64 saddle solve; the f32 system's condition number "
          "amplifies rounding", pred, (t1, t2), expect)

    # active_ss: planted ridge y = exp(0.7 w.x)
    k = sz.as_dim
    w_true = rng.standard_normal(k)
    w_true /= np.linalg.norm(w_true)
    xa = rng.uniform(-1.0, 1.0, (sz.as_points, k)).astype(np.float32)
    ya = np.exp(0.7 * xa.astype(np.float64) @ w_true).astype(np.float32)
    xad, yad = jnp.asarray(xa), jnp.asarray(ya[:, None])
    out, t1, t2 = twice(lambda: api.active_ss(xad, yad, 1, 30, 2))
    comp = np.asarray(out[0], np.float64)[:, 0]
    cos = abs(comp @ w_true) / np.linalg.norm(comp)
    check("rom", f"api.active_ss {sz.as_points}x{k}, 30 neighbours: "
                 "1 - |cos(w)|", 1.0 - cos, 0.01,
          "planted ridge direction; the issue asks |cos| > 0.99", out,
          (t1, t2), expect)


PHASES = {
    "rsvd": phase_rsvd,
    "single_pass": phase_single_pass,
    "dream": phase_dream,
    "dirichlet": phase_dirichlet,
    "dmd": phase_dmd,
    "rom": phase_rom,
}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _shard_rows_held(arr) -> list:
    return sorted(s.data.shape[0] for s in arr.addressable_shards)


def phase_sharded_rsvd(sz: Sizes, expect: str, n_dev: int = 4):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from corrla_rs_tpu.ops.random_svd import random_svd
    from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd

    devs = jax.devices()[:n_dev]
    mesh = Mesh(np.array(devs), ("rows",))
    rows_sh = NamedSharding(mesh, P("rows", None))
    sigma = 100.0 / np.arange(1, sz.planted_rank + 1, dtype=np.float64)
    a = jax.device_put(
        planted_matrix(jax.random.key(13), sz.sharded_rows, sz.cols, sigma),
        rows_sh)
    a = jax.block_until_ready(a)
    held = _shard_rows_held(a)
    note("sharded_rsvd", f"matrix {sz.sharded_rows}x{sz.cols} f32 "
                         f"({a.size * 4 / 1e9:.1f} GB), rows per card {held}")
    if held != [sz.sharded_rows // n_dev] * n_dev:
        raise SmokeFailure(f"matrix rows per card {held}")
    out, t1, t2 = twice(lambda: sharded_random_svd(
        a, sz.rank, sz.n_iter, sz.n_os, key=7, mesh=mesh))
    u_held = _shard_rows_held(out[0])
    note("sharded_rsvd", f"U rows per card {u_held}")
    if u_held != [sz.sharded_rows // n_dev] * n_dev:
        raise SmokeFailure(f"U rows per card {u_held}")
    a1 = jax.block_until_ready(jax.device_put(a, devs[0]))
    one, o1, o2 = twice(lambda: random_svd(
        a1, sz.rank, sz.n_iter, sz.n_os, key=7, stabilize="always",
        qr_method="cholesky"))
    note("sharded_rsvd", f"single-card random_svd first={o1:.3f}s "
                         f"second={o2:.3f}s")
    s_sh = np.asarray(out[1], np.float64)
    s_one = np.asarray(one[1], np.float64)
    check("sharded_rsvd", "sigma vs single-card random_svd (same key)",
          np.max(np.abs(s_sh - s_one) / s_one), 1e-5,
          "same sketch; f32 partial Gram sums in another order",
          out, (t1, t2), expect)
    top = sz.rank // 2
    check("sharded_rsvd", f"sigma_1..{top} vs planted",
          np.max(np.abs(s_sh[:top] - sigma[:top]) / sigma[:top]), 1e-5,
          f"power-iteration residual (sigma_{sz.rank + sz.n_os + 1}/"
          f"sigma_{top})^{4 * sz.n_iter + 2} is below f32 rounding",
          out, (t1, t2), expect)


def phase_sharded_dream(sz: Sizes, expect: str, n_dev: int = 4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from corrla_rs_tpu.parallel.sharded_samplers import dream_run_sharded

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("chains",))

    def lnp(x):
        return -0.5 * jnp.sum(x * x)

    heads0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((sz.sharded_chains, 3)),
        jnp.float32)
    out, t1, t2 = twice(lambda: dream_run_sharded(
        heads0, lnp, sz.dream_steps, key=1, mesh=mesh)[:2])
    hist, final = out
    held = _shard_rows_held(final)
    note("sharded_dream", f"{sz.sharded_chains} chains on a {n_dev}-way "
                          f"chains mesh; chains per card {held}")
    if held != [sz.sharded_chains // n_dev] * n_dev:
        raise SmokeFailure(f"chains per card {held}")
    tail = np.asarray(hist[sz.dream_steps // 2:], np.float64).reshape(-1, 3)
    check("sharded_dream", "pooled mean (2nd half)",
          np.max(np.abs(tail.mean(axis=0))), 0.05, "target mean 0",
          out, (t1, t2), expect)
    check("sharded_dream", "pooled variance - 1 (2nd half)",
          np.max(np.abs(tail.var(axis=0) - 1.0)), 0.05,
          "target variance 1, within 5%", out, (t1, t2), expect)


SHARDED_PHASES = {
    "sharded_rsvd": phase_sharded_rsvd,
    "sharded_dream": phase_sharded_dream,
}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def gpu_query() -> str:
    """nvidia-smi's name and power limit, read by a child that has no JAX."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return proc.stdout.strip() or f"nvidia-smi rc={proc.returncode}"


def run(phases: dict, sz: Sizes, expect: str) -> None:
    for name, fn in phases.items():
        t0 = time.perf_counter()
        fn(sz, expect)
        note(name, f"phase done in {time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs the sharded phases only, on four cards")
    args = ap.parse_args(argv)

    print(f"nvidia-smi: {gpu_query()}", flush=True)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2

    from corrla_rs_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"devices: {[d.device_kind for d in devices]}", flush=True)

    if args.cards == 4:
        run(SHARDED_PHASES, FULL, "gpu")
    else:
        run(PHASES, FULL, "gpu")

    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
