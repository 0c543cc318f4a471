"""Randomized SVD — the compute core every model composes.

Halko / Martinsson-Tropp randomized range finder (alg. 9 of
arxiv.org/pdf/2002.01387) with subspace power iteration. Functional parity
with the reference (random_svd.rs:15-110):

- Gaussian sketch Omega in R^{m x k} (random_svd.rs:24)
- Y = A @ Omega, then ``n_iter`` iterations of Y <- A (A^T Y)
  (random_svd.rs:31,42-51)
- thin-QR re-orthonormalization only when iter > 2, with a cheap
  Frobenius-norm rescale every iteration (random_svd.rs:37-39,53-55)
- final thin QR (random_svd.rs:57), B = Q^T A, dense SVD of the small B
  (random_svd.rs:80,89), U = Q @ U_B, truncate to rank
  (random_svd.rs:92-109)
- fat inputs (nrows < ncols) handled by transposition (random_svd.rs:69-74)

Accelerator design notes:

- The two big matmuls per power iteration dominate; matmul precision is
  HIGHEST (full f32) by default, which f32 needs to hit sigma rel-err
  < 1e-6 (the GPU's default for f32 is TF32).
- ``stabilize='always'`` does QR every iteration — numerically stronger in
  f32 than the reference's skip-first-3 heuristic; ``'reference'`` keeps
  iteration-count parity with the reference behavior.
- Everything is jit-safe with static shapes; the power-iteration loop is a
  ``lax.fori_loop`` so compile time is independent of ``n_iter``.
- Multi-device: see corrla_rs_tpu.parallel.sharded_rsvd (row-sharded A over
  a device mesh, psum'd Gram products, CholeskyQR2 for the distributed
  thin-QR).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key

__all__ = [
    "power_iter", "random_svd", "block_krylov_svd", "single_pass_svd",
    "sigma_values",
]


def _householder_qr(y: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.qr(y, mode="reduced")[0]


def _cholesky_qr2(y: jnp.ndarray) -> jnp.ndarray:
    """Preconditioned CholeskyQR with ridge fallback (3 rounds).

    Per round: column-normalize (exact diagonal preconditioning — power
    iteration leaves subordinate columns whose squared norms underflow),
    form the k x k Gram, Cholesky with a *small* ridge, and — only if that
    produced non-finite values (deficient panels: sketch rank > numerical
    rank happens routinely for POD snapshot families / exactly-low-rank
    DMD data, where the Gram is indefinite at working precision) — retry
    with a large ridge. Both factorizations are k x k (trivial); the
    select keeps the high-accuracy path for well-conditioned panels
    (sigma parity < 1e-6) while deficient panels degrade gracefully to
    ~ridge-level orthonormality in their junk directions, which the next
    round cleans up.

    (eigh-based Loewdin whitening was rejected: 1/sqrt(w_small)
    amplifies the f32 eigh's error catastrophically.)

    Its cost is one Gram matmul and a k x k Cholesky per round, instead
    of Householder QR's long sequence of panel updates over the tall
    matrix.
    """
    dtype = y.dtype
    if dtype == jnp.float32:
        # eps_big must exceed the worst-case negative eigenvalue of a
        # rounded deficient Gram (~k * sqrt(n) * 2^-24); the next round's
        # small-eps pass removes the distortion it introduces
        eps_small, eps_big = 1e-7, 1e-2
    else:
        eps_small, eps_big = 1e-15, 1e-8
    k = y.shape[1]
    tiny = jnp.asarray(1e-30 if dtype == jnp.float32 else 1e-290, dtype)
    eye = jnp.eye(k, dtype=dtype)

    def one_round(y):
        cn = jnp.maximum(jnp.linalg.norm(y, axis=0), tiny)
        ys = y / cn[None, :]
        g = jnp.matmul(ys.T, ys, precision=PRECISION)
        r_small = jnp.linalg.cholesky(g + eps_small * eye, upper=True)
        ok = jnp.all(jnp.isfinite(r_small))
        r_big = jnp.linalg.cholesky(g + eps_big * eye, upper=True)
        r = jnp.where(ok, r_small, r_big)
        return lax.linalg.triangular_solve(r, ys, left_side=False, lower=False)

    return one_round(one_round(one_round(y)))


def sigma_values(b: jnp.ndarray) -> jnp.ndarray:
    """Singular values of the small projected matrix B, descending.

    A values-only QR-algorithm SVD (LAPACK gesvd without vectors, dqds).
    On the GPU the vector-computing SVD loses accuracy in f32: at the
    100k x 10k bench shape its sigma carried 2.0e-6 max relative error
    against float64 (gesvd with vectors) and 1.4e-5 at 10k x 1k (Jacobi,
    which JAX picks below 1024 columns), against 1.4e-7 here (H100). The
    sigma target is 1e-6.

    On the CPU it is LAPACK's values-only default (gesdd): accurate there,
    and unlike gesvd a custom call that ``jax.export`` may serialize.
    """
    def values_only(b, algorithm=None):
        return lax.linalg.svd(b, full_matrices=False, compute_uv=False,
                              algorithm=algorithm)

    return lax.platform_dependent(
        b, cpu=values_only,
        default=lambda b: values_only(b, lax.linalg.SvdAlgorithm.QR),
    )


def _thin_qr(y: jnp.ndarray, qr_method: str = "householder") -> jnp.ndarray:
    if qr_method == "cholesky":
        return _cholesky_qr2(y)
    return _householder_qr(y)


def power_iter(
    a: jnp.ndarray,
    omega_rank: int,
    n_iter: int,
    key=0,
    stabilize: str = "auto",
    precision=PRECISION,
    qr_method: str = "auto",
) -> jnp.ndarray:
    """Randomized range finder: orthonormal Q approximating range(A).

    Parity with reference random_svd.rs:15-59. ``stabilize``:
      - 'auto' (default): 'always' for f32 inputs, 'reference' for f64.
        In f32 the reference's skip-first-3 heuristic is *numerically
        wrong* for decaying spectra: three unorthogonalized power steps
        amplify (s1/sk)^6, which overflows the f32 mantissa range and
        permanently collapses the subordinate sketch directions (observed:
        POD modes of a 20-snapshot pulse family reconstructed with rel err
        ~1.0 in f32 under 'reference', ~truncation-limited under
        'always').
      - 'reference': thin-QR only when iteration index > 2 (the reference
        heuristic, random_svd.rs:37-39), L2 rescale every iteration.
      - 'always': thin-QR every iteration.
    ``qr_method``: 'auto' (default: cholesky fast path when stabilize
    resolves to 'always', householder otherwise), 'householder'
    (LAPACK-style, safest) or 'cholesky' (see _cholesky_qr2). The final
    orthonormalization is always Householder.
    """
    key = as_key(key)
    n, m = a.shape
    if stabilize == "auto":
        stabilize = "always" if a.dtype == jnp.float32 else "reference"
    if qr_method == "auto":
        # CholeskyQR2 is cheaper than Householder on tall panels but needs
        # well-conditioned panels — guaranteed only when every iteration
        # re-orthonormalizes; pair it with 'always' and keep Householder
        # for the reference skip-QR heuristic.
        qr_method = "cholesky" if stabilize == "always" else "householder"
    omega = jax.random.normal(key, (m, omega_rank), dtype=a.dtype)
    y = jnp.matmul(a, omega, precision=precision)
    qr = lambda q: _thin_qr(q, qr_method)

    def body(i, y):
        if stabilize == "always":
            y = qr(y)
        else:
            y = lax.cond(i > 2, qr, lambda q: q, y)
        z = jnp.matmul(a.T, y, precision=precision)
        y = jnp.matmul(a, z, precision=precision)
        # guard: a zero panel (e.g. A == 0) must not produce 0/0 = NaN
        y = y / jnp.maximum(jnp.linalg.norm(y), jnp.asarray(1e-30, y.dtype))
        return y

    y = lax.fori_loop(0, n_iter, body, y)
    # The FINAL orthonormalization determines B = Q^T A and hence every
    # sigma/mode downstream: use exact Householder even on the cholesky
    # fast path. In-loop CholeskyQR only needs to keep the panel
    # conditioned; on rank-deficient sketches its ridge-fallback leaves
    # junk directions ~1e-2 off orthonormal, which (via Householder here)
    # never reaches B. Cost: one Householder QR per call instead of
    # n_iter of them.
    return _thin_qr(y, "householder")


@functools.partial(
    jax.jit,
    static_argnames=(
        "omega_rank", "n_iter", "n_oversamples", "stabilize", "qr_method",
        "power_precision",
    ),
)
def random_svd(
    a: jnp.ndarray,
    omega_rank: int,
    n_iter: int,
    n_oversamples: int,
    key=0,
    stabilize: str = "auto",
    qr_method: str = "auto",
    power_precision=PRECISION,
):
    """Randomized SVD: A ~= U @ diag(s) @ Vt with U (m, r), s (r,), Vt (r, n).

    Parity with reference random_svd.rs:63-110 (including the fat-matrix
    transpose path). The small-B dense SVD is replicated work (B is
    (k, min_dim)).
    """
    key = as_key(key)
    fat = a.shape[0] < a.shape[1]
    aa = a.T if fat else a

    sketch_rank = min(omega_rank + n_oversamples, aa.shape[1])
    rank = min(omega_rank, sketch_rank)

    # power_precision: matmul precision of the power iteration only (the
    # B = Q^T A product stays HIGHEST). On the GPU, Precision.HIGH is
    # TF32; chip_smoke.py's rsvd phase measures each setting's sigma
    # error against float64 on the same sketch.
    q = power_iter(
        aa, sketch_rank, n_iter, key=key, stabilize=stabilize,
        qr_method=qr_method, precision=power_precision,
    )
    b = jnp.matmul(q.T, aa, precision=PRECISION)
    u_b, _s, vt = jnp.linalg.svd(b, full_matrices=False)
    s = sigma_values(b)
    u = jnp.matmul(q, u_b, precision=PRECISION)

    if fat:
        # A = (V) S (Q U_B)^T   since A^T ~= (Q U_B) S V^T
        return vt.T[:, :rank], s[:rank], u.T[:rank, :]
    return u[:, :rank], s[:rank], vt[:rank, :]


@functools.partial(
    jax.jit,
    static_argnames=("rank", "n_iter", "n_oversamples", "precision"),
)
def block_krylov_svd(
    a: jnp.ndarray,
    rank: int,
    n_iter: int,
    n_oversamples: int = 10,
    key=0,
    precision=PRECISION,
):
    """Randomized block-Krylov SVD (Musco & Musco 2015, arxiv 1504.05477).

    EXTENSION beyond the reference (which only has subspace iteration,
    random_svd.rs:15-59): instead of keeping only the last power iterate
    (A A^T)^q A Omega, retain the whole Krylov block

        K = [A Omega, (A A^T) A Omega, ..., (A A^T)^q A Omega]

    and take the range of K. Same number of passes over A as ``n_iter``
    subspace iterations, but convergence ~1/sqrt(eps) iterations instead
    of ~1/eps — on gapless spectra (where subspace iteration stalls) the
    sigma error at a fixed pass budget is typically an order of magnitude
    smaller (see tests/test_random_svd.py for the measured comparison).
    Cost: the final QR/SVD run on an (n, k*(q+1)) block instead of (n, k)
    — the right trade when passes over A dominate, i.e. tall matrices on
    HBM-bound hardware.

    Returns (U (n, rank), s (rank,), Vt (rank, m)) like ``random_svd``.
    """
    key = as_key(key)
    fat = a.shape[0] < a.shape[1]
    aa = a.T if fat else a
    n, m = aa.shape
    k = min(rank + n_oversamples, m)
    q = max(int(n_iter), 0)

    omega = jax.random.normal(key, (m, k), dtype=aa.dtype)
    y = jnp.matmul(aa, omega, precision=precision)

    def body(i, carry):
        y, blocks = carry
        # orthonormalize the running block for numerical range quality
        y = _cholesky_qr2(y)
        z = jnp.matmul(aa.T, y, precision=precision)
        y = jnp.matmul(aa, z, precision=precision)
        blocks = lax.dynamic_update_slice_in_dim(blocks, y, (i + 1) * k, 1)
        return y, blocks

    blocks0 = jnp.zeros((n, k * (q + 1)), aa.dtype)
    blocks0 = lax.dynamic_update_slice_in_dim(blocks0, y, 0, 1)
    _y, blocks = lax.fori_loop(0, q, body, (y, blocks0))

    q_full = _thin_qr(blocks, "householder")
    b = jnp.matmul(q_full.T, aa, precision=PRECISION)
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q_full, u_b, precision=PRECISION)
    if fat:
        return vt.T[:, :rank], s[:rank], u.T[:rank, :]
    return u[:, :rank], s[:rank], vt[:rank, :]


@functools.partial(
    jax.jit,
    static_argnames=("rank", "n_oversamples", "core_oversamples", "precision"),
)
def single_pass_svd(
    a: jnp.ndarray,
    rank: int,
    n_oversamples: int = 10,
    core_oversamples: int | None = None,
    key=0,
    precision=PRECISION,
):
    """Two-sided sketch SVD (Tropp, Yurtsever, Udell & Cevher 2017,
    "Practical sketching algorithms for low-rank matrix approximation").

    EXTENSION beyond the reference (random_svd.rs only has subspace
    iteration): reads A exactly TWICE (range sketch Y = A Omega and
    co-range sketch W = Psi A — in a streaming setting both accumulate in
    the same single pass), vs 1 + 2*n_iter passes for ``random_svd``. On
    HBM-bandwidth-bound hardware this is the speed ceiling for low-rank
    approximation: at the bench shape (100k x 10k f32) the two passes cost
    ~6.5 ms where the power-iteration RSVD pays ~89 ms.

    The price is accuracy on flat spectra: with no power iterations the
    sketch captures sigma_i only up to the usual
    (sum of the tail) / (gap) factors — use it when the spectrum decays
    (measured: rel sigma err ~1e-2 at 2x oversampling on an i^-2
    power-law spectrum, fp-exact on exactly-low-rank data) or when A
    genuinely cannot be revisited (streaming snapshots). ``random_svd`` /
    ``block_krylov_svd`` remain the accuracy path.

    core_oversamples: extra rows in the co-range sketch (l = k + this).
    Tropp et al. recommend l ~ 2k for a stable core solve; default is
    l = 2k + 1 (capped by the matrix dimensions).

    Returns (U (n, rank), s (rank,), Vt (rank, m)) like ``random_svd``.
    """
    key = as_key(key)
    fat = a.shape[0] < a.shape[1]
    aa = a.T if fat else a
    n, m = aa.shape

    k = min(rank + n_oversamples, m)
    if core_oversamples is None:
        ell = min(2 * k + 1, n)
    else:
        ell = min(k + int(core_oversamples), n)

    k_om, k_psi = jax.random.split(key)
    omega = jax.random.normal(k_om, (m, k), dtype=aa.dtype)
    psi = jax.random.normal(k_psi, (ell, n), dtype=aa.dtype)

    y = jnp.matmul(aa, omega, precision=precision)      # pass 1: (n, k)
    w = jnp.matmul(psi, aa, precision=precision)        # pass 2: (ell, m)

    q = _householder_qr(y)                              # (n, k)
    # core: X = (Psi Q)^+ W via QR least squares ((ell, k) is tiny and
    # well-conditioned w.h.p. for ell ~ 2k)
    b = jnp.matmul(psi, q, precision=PRECISION)         # (ell, k)
    qb, rb = jnp.linalg.qr(b, mode="reduced")
    x = lax.linalg.triangular_solve(
        rb, jnp.matmul(qb.T, w, precision=PRECISION),
        left_side=True, lower=False,
    )                                                   # (k, m)
    u_x, s, vt = jnp.linalg.svd(x, full_matrices=False)
    u = jnp.matmul(q, u_x, precision=PRECISION)
    if fat:
        return vt.T[:, :rank], s[:rank], u.T[:rank, :]
    return u[:, :rank], s[:rank], vt[:rank, :]
