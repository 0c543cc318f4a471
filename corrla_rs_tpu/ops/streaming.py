"""Out-of-core (host-streamed) randomized SVD / PCA / HOSVD.

The CPU reference factorizes any matrix that fits host RAM
(random_svd.rs:63-110 on faer host matrices); a single GPU has
80 GB of HBM. This module removes that limit: the matrix stays on the
host (numpy array, ``np.memmap``, or any row-sliceable source — see
``RowBlockSource`` for generator-backed virtual matrices), and fixed-size
row blocks stream host->device where jitted kernels accumulate the small
sketch/Gram factors. Device memory is O(n*k + m*k) (+ O(m^2) for the
Gram path) — never O(n*m).

Three algorithms, by passes over A (the streaming transfer is the
bottleneck, so passes are the budget):

- ``method='gram'`` (default): ONE data pass accumulates G = A^T A
  (m, m) on device; all ``n_iter`` power iterations then run on G
  on-device (W <- G W with CholeskyQR stabilization in m-space — exactly
  A (A^T A)^q Omega, the classic iteration, algebraically); one pass for
  Y = A W and one for B = Q^T A. 3 passes total, independent of n_iter.
  Needs the (m, m) Gram to fit (m <~ 40k f32).
- ``method='power'``: never forms G; each iteration applies
  H = A^T (A W) blockwise in one pass and stabilizes via CholeskyQR of
  W^T H (R^T R = (A W)^T (A W), so the QR never touches n-space).
  n_iter + 2 passes; device memory O(m*k). For m too big for the Gram.
- ``streamed_single_pass_svd``: the Tropp et al. two-sided sketch
  (ops/random_svd.single_pass_svd) with both sketches accumulated in ONE
  pass; the co-range test matrix Psi is regenerated per block from the
  PRNG key (never materialized at (ell, n)). For data that cannot be
  revisited at all; sketch-grade accuracy (good on decaying spectra).

Numerics: all accumulations run at HIGHEST matmul precision in f32.
The Gram/power paths square the condition number in the *stabilization
algebra* only — B = Q^T A is re-accumulated from the raw data, so
singular values keep f32-grade parity with the in-memory path for all
sigma_i above ~sqrt(eps_f32) * sigma_max (tested: identical-sketch parity
vs ``random_svd`` on control shapes).

Accelerator notes: block shapes are static (the last block is zero-padded)
so each kernel compiles once; ``jax.device_put`` is async, and the
driver dispatches the next block's transfer before computing on the
current one (double buffering), overlapping the PCIe transfer with
the matmuls.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.prng import as_key

__all__ = [
    "RowBlockSource",
    "streamed_random_svd",
    "streamed_single_pass_svd",
    "streamed_gram",
    "streamed_cov",
    "streamed_pearson_corr",
    "streamed_pca",
    "streamed_pod",
    "streamed_dmdc",
    "streamed_hosvd",
]


class RowBlockSource:
    """Adapter giving a block-producing callable the row-sliceable
    protocol the streaming drivers expect (``.shape``, ``.dtype``,
    ``src[start:stop]``).

    ``fn(start, stop)`` must return the rows ``[start, stop)`` as a host
    array of shape ``(stop - start,) + shape[1:]``. Use for matrices that
    are generated (simulation snapshots, database reads) rather than
    stored — nothing is ever materialized at full size.
    """

    def __init__(self, fn, shape, dtype=np.float32):
        self._fn = fn
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)

    def __getitem__(self, idx):
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise TypeError(
                "RowBlockSource supports contiguous row slices only"
            )
        start, stop, _ = idx.indices(self.shape[0])
        out = np.asarray(self._fn(start, stop), dtype=self.dtype)
        expect = (stop - start,) + self.shape[1:]
        if out.shape != expect:
            raise ValueError(
                f"block fn returned shape {out.shape}, expected {expect}"
            )
        return out


def _source_meta(a):
    shape = tuple(int(s) for s in a.shape)
    dtype = jnp.dtype(getattr(a, "dtype", np.float32))
    return shape, dtype


def _default_block_rows(n: int, row_elems: int, dtype) -> int:
    """~512 MB of source rows per block (>= 64 rows): big enough that the
    per-block dispatch/transfer latency amortizes, small enough that two
    in-flight blocks + accumulators leave HBM room."""
    itemsize = jnp.dtype(dtype).itemsize
    b = max(64, int(512e6 / max(row_elems * itemsize, 1)))
    return min(n, b)


def _iter_blocks(a, n, block_rows, pad_value=0.0):
    """Yield (i, host_block) with every block zero-padded to
    ``block_rows`` rows — one static shape, one compiled kernel."""
    n_blocks = -(-n // block_rows)
    for i in range(n_blocks):
        start = i * block_rows
        stop = min(start + block_rows, n)
        blk = np.asarray(a[start:stop])
        if stop - start < block_rows:
            pad = np.full(
                (block_rows - (stop - start),) + blk.shape[1:],
                pad_value, dtype=blk.dtype,
            )
            blk = np.concatenate([blk, pad], axis=0)
        yield i, blk


def _stream_accumulate(a, n, block_rows, init, step):
    """acc = step(acc, block_device, i) over all row blocks, double
    buffered: block i+1 transfers host->device while block i's compute
    runs. The ``block_until_ready`` on each fresh transfer bounds the
    in-flight transfers to ONE — device_put is async and an unbounded
    dispatch loop would otherwise enqueue the entire stream at once
    (observed: GBs of host-side transfer buffers pinned and the
    runtime's transfer queue saturated for minutes after the caller was
    killed)."""
    acc = init
    pending = None  # (i, device_block)
    for i, host_blk in _iter_blocks(a, n, block_rows):
        dev_blk = jax.device_put(host_blk)
        if pending is not None:
            acc = step(acc, pending[1], pending[0])
        dev_blk.block_until_ready()
        pending = (i, dev_blk)
    if pending is not None:
        acc = step(acc, pending[1], pending[0])
    return acc


# ---------------------------------------------------------------------------
# jitted per-block kernels (static block shape -> compiled once per run)
# ---------------------------------------------------------------------------


@jax.jit
def _acc_gram_and_sums(carry, blk):
    g, csum = carry
    g = g + jnp.matmul(blk.T, blk, precision=PRECISION)
    return g, csum + jnp.sum(blk, axis=0)


@jax.jit
def _acc_h(h, blk, w):
    """h += A_i^T (A_i w): one power-iteration pass contribution."""
    y = jnp.matmul(blk, w, precision=PRECISION)
    return h + jnp.matmul(blk.T, y, precision=PRECISION)


@jax.jit
def _blk_matmul(blk, w):
    return jnp.matmul(blk, w, precision=PRECISION)


@jax.jit
def _acc_b(b, q_i, blk):
    """b += Q_i^T A_i: the (k, m) small factor of B = Q^T A."""
    return b + jnp.matmul(q_i.T, blk, precision=PRECISION)


@jax.jit
def _chol_qr_cols(w, h):
    """Given H = A^T A W, orthonormalize the *columns of A W* without
    touching n-space: R^T R = W^T H = (A W)^T (A W); return H R^{-1}
    (= A^T A W stabilized, the next iterate) — CholeskyQR in m-space.

    Rank-deficient sketches (numerical rank of A below the sketch width
    — routine for exactly-low-rank sources): null-direction diagonals of
    W^T H round to ~0 while off-diagonal rounding noise does not, so the
    diagonal normalizer gets a RELATIVE floor (eps * max diag) that
    bounds the normalized entries, and the Cholesky carries the same
    small/large ridge fallback as ops/random_svd._cholesky_qr2 — junk
    directions degrade to ~ridge-level orthonormality and the final
    Householder QR (plus B re-accumulated from the raw data) keeps them
    out of every sigma. (Observed: NaN sigmas on a rank-6 generated
    source before the floor.)"""
    dtype = w.dtype
    if dtype == jnp.float32:
        eps_small, floor_rel = 1e-6, 1e-6
    else:
        eps_small, floor_rel = 1e-14, 1e-14
    # fallback ridge: with the floored normalizer the entries of ytyn are
    # bounded by ~1.1, so lambda_min >= -1.1 k; 2 (1 + k) dominates it
    eps_big = 2.0
    k = w.shape[1]
    yty = jnp.matmul(w.T, h, precision=PRECISION)
    # symmetrize (w^T h is Gram of A w up to rounding)
    yty = 0.5 * (yty + yty.T)
    diag = jnp.diagonal(yty)
    mx = jnp.maximum(jnp.max(diag), jnp.asarray(1e-300, dtype))
    d = jnp.sqrt(jnp.maximum(diag, floor_rel * mx))
    ytyn = yty / (d[:, None] * d[None, :])
    eye = jnp.eye(k, dtype=dtype)
    r_small = jnp.linalg.cholesky(ytyn + eps_small * eye, upper=True)
    ok = jnp.all(jnp.isfinite(r_small))
    r_big = jnp.linalg.cholesky(ytyn + eps_big * (1 + k) * eye, upper=True)
    r = jnp.where(ok, r_small, r_big)
    hn = h / d[None, :]
    return lax.linalg.triangular_solve(
        r, hn, left_side=False, lower=False
    )


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _gram_power(g, omega, n_iter):
    """W = orth-stabilized (G)^q Omega on device (G = A^T A resident)."""

    def body(_i, w):
        h = jnp.matmul(g, w, precision=PRECISION)
        return _chol_qr_cols(w, h)

    return lax.fori_loop(0, n_iter, body, omega)


def _stream_accumulate_multi(a, n, block_rows, init_fn, step, devices):
    """Round-robin multi-device streaming: block i transfers to
    ``devices[i % D]`` and accumulates into that device's own
    accumulator; per-device double buffering bounds in-flight transfers
    to one PER DEVICE (each accelerator has its own DMA engine, so D
    transfers overlap D computes on real multi-chip hosts — on a
    single-link host this degenerates gracefully to the serial driver).
    Returns the list of per-device accumulators (caller combines — for
    Gram-type sums, one device_put + add per device)."""
    import jax

    d_count = len(devices)
    accs = [init_fn(dev) for dev in devices]
    pending = [None] * d_count
    for i, host_blk in _iter_blocks(a, n, block_rows):
        d = i % d_count
        dev_blk = jax.device_put(host_blk, devices[d])
        if pending[d] is not None:
            accs[d] = step(accs[d], pending[d][1], pending[d][0])
        dev_blk.block_until_ready()
        pending[d] = (i, dev_blk)
    for d in range(d_count):
        if pending[d] is not None:
            accs[d] = step(accs[d], pending[d][1], pending[d][0])
    return accs


def streamed_gram(a, block_rows: int | None = None, devices=None):
    """G = A^T A (m, m) accumulated on device in one streamed pass, plus
    the column-sum vector (for centering). Returns ``(g, col_sums, n)``.

    The building block for out-of-core PCA/Pearson: the covariance of the
    centered data is ``(g - outer(s, s)/n) / (n - 1)``.

    devices: optional list of jax devices — row blocks round-robin
    across them with per-device partial Grams combined at the end
    (multi-accelerator hosts overlap D transfers/computes; the partial
    sums are exact, so the result is placement-independent up to fp
    reduction order).
    """
    import jax

    (n, m), dtype = _source_meta(a)
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    if devices is None:
        g0 = jnp.zeros((m, m), dtype)
        s0 = jnp.zeros((m,), dtype)
        g, s = _stream_accumulate(
            a, n, block_rows, (g0, s0),
            lambda acc, blk, _i: _acc_gram_and_sums(acc, blk),
        )
        return g, s, n
    accs = _stream_accumulate_multi(
        a, n, block_rows,
        lambda dev: (
            jax.device_put(jnp.zeros((m, m), dtype), dev),
            jax.device_put(jnp.zeros((m,), dtype), dev),
        ),
        lambda acc, blk, _i: _acc_gram_and_sums(acc, blk),
        devices,
    )
    g = accs[0][0]
    s = accs[0][1]
    for gd, sd in accs[1:]:
        g = g + jax.device_put(gd, devices[0])
        s = s + jax.device_put(sd, devices[0])
    return g, s, n


def streamed_cov(a, block_rows: int | None = None, devices=None):
    """Out-of-core sample covariance of columns (``mat_cov_centered``
    semantics, stats_corr.rs:32-43) in ONE streamed pass: implicit
    centering off the Gram, cov = (G - s s^T / n) / (n - 1).

    Numerics: single-pass implicit centering cancels catastrophically
    when |column mean| >> column std (error ~ eps * mean^2/var); for such
    data pre-shift the source by an approximate mean (any constant shift
    leaves the covariance unchanged) or stream in f64.
    """
    g, s, n = streamed_gram(a, block_rows, devices)
    return (g - jnp.outer(s, s) / n) / (n - 1.0)


def streamed_pearson_corr(a, block_rows: int | None = None, devices=None):
    """Out-of-core Pearson correlation matrix between columns
    (``pearson_corr`` semantics, stats_corr.rs:14-28) in ONE streamed
    pass — the reference's only scale limit is host RAM; this one's is
    host storage. Same implicit-centering caveat as ``streamed_cov``.
    """
    cov = streamed_cov(a, block_rows, devices)
    d = jnp.sqrt(jnp.diagonal(cov))
    return cov / jnp.outer(d, d)


def streamed_random_svd(
    a,
    rank: int,
    n_iter: int,
    n_oversamples: int = 10,
    key=0,
    block_rows: int | None = None,
    method: str = "gram",
    center: bool = False,
    devices=None,
):
    """Out-of-core randomized SVD: A never resident on device.

    a: host row-sliceable source (numpy array / ``np.memmap`` /
    ``RowBlockSource``) of shape (n, m) with m small enough for (m, k)
    [+ (m, m) for 'gram'] device factors. Returns ``(u, s, vt)`` like
    ``ops.random_svd.random_svd`` — u is (n, rank) ON DEVICE (n*rank must
    fit, e.g. 1M x 100 f32 = 400 MB).

    method='gram' (default): 3 passes over A total. method='power':
    n_iter + 2 passes, no (m, m) storage. center=True subtracts the
    column means implicitly (exact, via the Gram/sum algebra) — the
    out-of-core PCA path; supported for method='gram'.

    devices: optional list of jax devices (method='gram' only) — every
    streamed pass round-robins row blocks across them with per-device
    partial accumulators (Gram, Y blocks, B contributions) combined on
    ``devices[0]``; on multi-accelerator hosts the D host->device DMA
    queues and computes overlap. Results match the single-device path up
    to fp reduction order.

    Parity: same sketch-distribution semantics as the in-memory path;
    sigma agreement tested on control shapes (tests/test_streaming.py).
    Reference scale story: random_svd.rs:63-110 is bounded by host RAM;
    this driver is bounded by host storage instead.
    """
    (n, m), dtype = _source_meta(a)
    if n < m:
        raise ValueError(
            "streamed_random_svd streams ROW blocks and requires n >= m "
            f"(got {n} x {m}); store the transpose (tall orientation) — "
            "an out-of-core transpose would re-read the source m/block "
            "times"
        )
    if center and method != "gram":
        raise ValueError("center=True requires method='gram'")
    if method not in ("gram", "power"):
        raise ValueError(f"method must be 'gram' or 'power', got {method!r}")
    if devices is not None and method != "gram":
        raise ValueError("devices= requires method='gram'")
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    k = min(int(rank) + int(n_oversamples), m)
    rank = min(int(rank), k)
    key = as_key(key)
    omega = jax.random.normal(key, (m, k), dtype=dtype)

    if method == "gram":
        if n_iter <= 0 and not center:
            # neither the Gram nor the column sums would be consumed:
            # skip the whole pass (passes over A are the budget) — the
            # sketch-only factorization needs 2 passes, not 3
            csum = jnp.zeros((m,), dtype)
            w = omega
            if devices is not None:
                w = jax.device_put(w, devices[0])
        else:
            g, csum, _ = streamed_gram(a, block_rows=block_rows,
                                       devices=devices)
            if devices is not None:
                omega = jax.device_put(omega, devices[0])
            if center:
                mu = csum / n
                g = g - n * jnp.outer(mu, mu)
            w = _gram_power(g, omega, int(n_iter)) if n_iter > 0 else omega
    else:
        w = omega
        for _ in range(int(n_iter)):
            h = _stream_accumulate(
                a, n, block_rows, jnp.zeros((m, k), dtype),
                lambda h, blk, _i, w=w: _acc_h(h, blk, w),
            )
            w = _chol_qr_cols(w, h)

    # pass: Y = (A - 1 mu^T) W, blockwise, device-resident (n_pad, k)
    if center:
        mu_w = jnp.matmul((csum / n)[None, :], w, precision=PRECISION)
    else:
        mu_w = jnp.zeros((1, k), dtype)
    if devices is None:
        y_blocks = _stream_accumulate(
            a, n, block_rows, [],
            lambda ys, blk, _i: ys + [_blk_matmul(blk, w) - mu_w],
        )
    else:
        w_reps = [jax.device_put(w, d) for d in devices]
        mu_reps = [jax.device_put(mu_w, d) for d in devices]
        per_dev = _stream_accumulate_multi(
            a, n, block_rows, lambda _dev: [],
            lambda ys, blk, i: ys + [
                (i, _blk_matmul(blk, w_reps[i % len(devices)])
                 - mu_reps[i % len(devices)])
            ],
            devices,
        )
        indexed = sorted(
            (i, y_i) for ys in per_dev for (i, y_i) in ys
        )
        y_blocks = [jax.device_put(y_i, devices[0]) for _i, y_i in indexed]
    y = jnp.concatenate(y_blocks, axis=0)  # (n_pad, k); pad rows == -mu_w
    # zero the pad rows (centering makes them nonzero; they must not
    # influence the range)
    n_pad = y.shape[0]
    if n_pad != n:
        row = jnp.arange(n_pad)
        y = jnp.where((row < n)[:, None], y, 0.0)
    q = jnp.linalg.qr(y, mode="reduced")[0]  # final QR: exact Householder

    # pass: B = Q^T (A - 1 mu^T) = sum_i Q_i^T A_i - (Q^T 1) mu^T
    def b_step(acc, blk, i):
        q_i = lax.dynamic_slice_in_dim(q, i * block_rows, block_rows, 0)
        return _acc_b(acc, q_i, blk)

    if devices is None:
        b = _stream_accumulate(
            a, n, block_rows, jnp.zeros((k, m), dtype), b_step
        )
    else:
        def b_step_multi(acc, blk, i):
            d = devices[i % len(devices)]
            q_i = jax.device_put(
                lax.dynamic_slice_in_dim(q, i * block_rows, block_rows, 0),
                d,
            )
            return _acc_b(acc, q_i, blk)

        partials = _stream_accumulate_multi(
            a, n, block_rows,
            lambda dev: jax.device_put(jnp.zeros((k, m), dtype), dev),
            b_step_multi,
            devices,
        )
        b = partials[0]
        for bp in partials[1:]:
            b = b + jax.device_put(bp, devices[0])
    if center:
        q1 = jnp.sum(q[:n], axis=0)  # pad rows of q are exactly zero
        b = b - jnp.outer(q1, csum / n)

    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=PRECISION)[:n]
    return u[:, :rank], s[:rank], vt[:rank, :]


def streamed_single_pass_svd(
    a,
    rank: int,
    n_oversamples: int = 10,
    core_oversamples: int | None = None,
    key=0,
    block_rows: int | None = None,
):
    """One-pass out-of-core sketch SVD (Tropp et al. 2017 two-sided
    sketch — the algorithm of ``ops.random_svd.single_pass_svd``, with
    both sketches accumulated while A streams by ONCE).

    The co-range test matrix Psi (ell, n) is never materialized: its
    column block for rows [i*b, (i+1)*b) is regenerated from
    ``fold_in(key, i)`` on device, both during the accumulation pass and
    the later (device-only) B = Psi Q product. Use when the source truly
    cannot be revisited; accuracy is sketch-grade (see single_pass_svd's
    docstring for the measured regimes).
    """
    (n, m), dtype = _source_meta(a)
    if n < m:
        raise ValueError(
            f"streamed_single_pass_svd requires tall input (n >= m), got "
            f"{n} x {m}; store the transpose"
        )
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    k = min(int(rank) + int(n_oversamples), m)
    rank = min(int(rank), k)
    key = as_key(key)
    k_om, k_psi = jax.random.split(key)
    n_blocks = -(-n // block_rows)
    n_pad = n_blocks * block_rows
    omega = jax.random.normal(k_om, (m, k), dtype=dtype)
    ell = min(2 * k + 1 if core_oversamples is None
              else k + int(core_oversamples), n)

    # Psi columns for each row block are regenerated from fold_in(key, i);
    # pad rows beyond n multiply zero data so their Psi values are harmless
    ys, w = _stream_accumulate(
        a, n, block_rows, ([], jnp.zeros((ell, m), dtype)),
        lambda carry, blk, i: (
            carry[0] + [_blk_matmul(blk, omega)],
            _acc_w(carry[1], blk, k_psi, i, block_rows, ell),
        ),
    )
    y = jnp.concatenate(ys, axis=0)  # (n_pad, k); pad rows are zero
    q = jnp.linalg.qr(y, mode="reduced")[0]

    # B = Psi Q accumulated block-by-block on device (Psi regenerated)
    b = jnp.zeros((ell, k), dtype)
    for i in range(n_blocks):
        q_i = lax.dynamic_slice_in_dim(q, i * block_rows, block_rows, 0)
        b = _acc_psi_q(b, q_i, k_psi, i, block_rows, ell)

    qb, rb = jnp.linalg.qr(b, mode="reduced")
    x = lax.linalg.triangular_solve(
        rb, jnp.matmul(qb.T, w, precision=PRECISION),
        left_side=True, lower=False,
    )
    u_x, s, vt = jnp.linalg.svd(x, full_matrices=False)
    u = jnp.matmul(q, u_x, precision=PRECISION)[:n]
    return u[:, :rank], s[:rank], vt[:rank, :]


@functools.partial(jax.jit, static_argnames=("block_rows", "ell"))
def _acc_w(w, blk, k_psi, i, block_rows, ell):
    psi_i = jax.random.normal(
        jax.random.fold_in(k_psi, i), (ell, block_rows), dtype=blk.dtype
    )
    return w + jnp.matmul(psi_i, blk, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("block_rows", "ell"))
def _acc_psi_q(b, q_i, k_psi, i, block_rows, ell):
    psi_i = jax.random.normal(
        jax.random.fold_in(k_psi, i), (ell, block_rows), dtype=q_i.dtype
    )
    return b + jnp.matmul(psi_i, q_i, precision=PRECISION)


def streamed_pca(a, n_comps: int, n_iter: int = 20,
                 n_oversamples: int | None = None, key=0,
                 block_rows: int | None = None, devices=None):
    """Out-of-core PCA: reference ``PcaRsvd`` semantics (pca_rsvd.rs:56-82
    — column centering, RSVD with 20 power iters, min(n_dim, 10)
    oversamples) on a host-resident sample matrix of any length.

    Returns ``(singular_values (r, 1), components (r, m))`` matching
    ``api.rpca``'s layout.
    """
    (_n, m), _ = _source_meta(a)
    if n_oversamples is None:
        n_oversamples = min(m, 10)
    _u, s, vt = streamed_random_svd(
        a, int(n_comps), n_iter, n_oversamples, key=key,
        block_rows=block_rows, method="gram", center=True,
        devices=devices,
    )
    return s[:, None], vt


def streamed_hosvd(tensor, ranks, block_slabs: int | None = None,
                   compute_mode0_rows: bool = True):
    """Out-of-core truncated HOSVD for a tensor streamed in slabs along
    axis 0 (the long axis — e.g. space in a (space, time, param) snapshot
    tensor bigger than HBM).

    Every mode factor comes from the eigendecomposition of that mode's
    Gram matrix, accumulated slab-by-slab on device:

    - mode 0 (long axis): G_0^c = X_(0)^T X_(0) (N, N) with
      N = prod(other dims); U_0 = X_(0) V_r S_r^{-1} in a second pass
      (the tall-matrix left-vectors-from-right-Gram identity).
    - modes k >= 1 (short axes): G_k = X_(k) X_(k)^T (I_k, I_k)
      accumulated from each slab's mode-k unfolding.
    - core: third pass, core += U_0[rows]^T (slab x_1 U_1^T x_2 ...).

    3 passes total, device memory O(N^2 + I_0 r_0 + core). Requires
    N = prod(shape[1:]) small enough for the (N, N) Gram — the regime
    where axis 0 is the out-of-core axis. Returns ``(core, factors)``
    like ``ops.hosvd.hosvd``.
    """
    from corrla_rs_tpu.ops.hosvd import mode_multiply

    shape, dtype = _source_meta(tensor)
    ndim = len(shape)
    if ndim < 2:
        raise ValueError("streamed_hosvd needs a tensor of ndim >= 2")
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != ndim:
        raise ValueError(
            f"ranks {ranks} must have one entry per tensor mode ({ndim})"
        )
    for kk, (r, d) in enumerate(zip(ranks, shape)):
        if not 1 <= r <= d:
            raise ValueError(
                f"ranks[{kk}]={r} must be in [1, {d}]"
            )
    n0 = shape[0]
    rest = shape[1:]
    n_rest = int(np.prod(rest))
    if ranks[0] > n_rest:
        # fail BEFORE streaming the (possibly multi-GB) source: the
        # mode-0 unfolding has only n_rest columns, so its rank is
        # structurally capped there and the core reshape would die late
        # with an opaque broadcasting error otherwise
        raise ValueError(
            f"ranks[0]={ranks[0]} exceeds prod(other dims)={n_rest}; the "
            "mode-0 unfolding cannot have higher rank — lower ranks[0]"
        )
    if block_slabs is None:
        block_slabs = _default_block_rows(n0, n_rest, dtype)

    # pass 1: all mode Grams at once
    @jax.jit
    def gram_step(carry, slab):
        g0, gs = carry
        flat = slab.reshape(slab.shape[0], -1)  # slab mode-0 unfolding
        g0 = g0 + jnp.matmul(flat.T, flat, precision=PRECISION)
        new_gs = []
        for kk in range(1, ndim):
            unf = jnp.moveaxis(slab, kk, 0).reshape(shape[kk], -1)
            new_gs.append(
                gs[kk - 1]
                + jnp.matmul(unf, unf.T, precision=PRECISION)
            )
        return g0, new_gs

    g0_init = jnp.zeros((n_rest, n_rest), dtype)
    gs_init = [jnp.zeros((shape[kk], shape[kk]), dtype)
               for kk in range(1, ndim)]
    g0, gs = _stream_accumulate(
        tensor, n0, block_slabs, (g0_init, gs_init),
        lambda c, blk, _i: gram_step(c, blk),
    )

    # short-mode factors: leading eigenvectors of the small Grams
    factors = [None] * ndim
    for kk in range(1, ndim):
        wv, vv = jnp.linalg.eigh(gs[kk - 1])
        factors[kk] = vv[:, ::-1][:, : ranks[kk]]

    # mode-0 factor from the co-Gram: V_r, S_r of X_(0)
    w0, v0 = jnp.linalg.eigh(g0)
    w0 = w0[::-1]
    v0 = v0[:, ::-1]
    s0 = jnp.sqrt(jnp.maximum(w0[: ranks[0]], 1e-30))
    v0r = v0[:, : ranks[0]]

    # passes 2+3 fused: U_0 rows and the core accumulate from the same
    # slab stream. Factor arrays are explicit jit arguments (NOT closure
    # captures, which would bake them into the executable as literals).
    @jax.jit
    def proj_kernel(core, slab, v0r, s0, short_factors):
        proj = slab
        for kk in range(1, ndim):
            proj = mode_multiply(proj, short_factors[kk - 1].T, kk)
        flat = slab.reshape(slab.shape[0], -1)
        u_blk = jnp.matmul(flat, v0r, precision=PRECISION) / s0[None, :]
        pf = proj.reshape(proj.shape[0], -1)
        core = core + jnp.matmul(u_blk.T, pf, precision=PRECISION)
        return core, u_blk

    short_factors = tuple(factors[1:])

    def proj_step(carry, slab, _i):
        core, u_rows = carry
        core, u_blk = proj_kernel(core, slab, v0r, s0, short_factors)
        if not compute_mode0_rows:
            # honor the memory promise: don't keep the O(n0 * r0)
            # factor resident when the caller declined it
            return core, u_rows
        return core, u_rows + [u_blk]

    core_flat0 = jnp.zeros((ranks[0], int(np.prod(ranks[1:]))), dtype)
    core_flat, u_blocks = _stream_accumulate(
        tensor, n0, block_slabs, (core_flat0, []), proj_step
    )
    core = core_flat.reshape(ranks)
    if compute_mode0_rows:
        u0 = jnp.concatenate(u_blocks, axis=0)[:n0]
    else:
        u0 = None
    factors[0] = u0
    return core, factors


def _iter_col_blocks(x, n_cols, block_cols):
    """Yield (i, host_block) of column slices ``x[:, lo:hi]``, the last
    block zero-padded to ``block_cols`` (one static kernel shape)."""
    n_blocks = -(-n_cols // block_cols)
    for i in range(n_blocks):
        lo = i * block_cols
        hi = min(lo + block_cols, n_cols)
        blk = np.asarray(x[:, lo:hi])
        if hi - lo < block_cols:
            pad = np.zeros(
                (blk.shape[0], block_cols - (hi - lo)), dtype=blk.dtype
            )
            blk = np.concatenate([blk, pad], axis=1)
        yield i, blk


@jax.jit
def _acc_snapshot_gram(h, blk):
    """H += X_c X_c^T for a column (spatial) chunk — zero-padded columns
    contribute nothing."""
    return h + jnp.matmul(blk, blk.T, precision=PRECISION)


@jax.jit
def _modes_chunk(blk, vs):
    return jnp.matmul(blk.T, vs, precision=PRECISION)


def streamed_pod(x, t, n_modes: int, block_cols: int | None = None):
    """Out-of-core POD: spatial grids larger than memory, via the method
    of snapshots (Sirovich 1987).

    x: (n_snapshots, n_points) with n_points huge — any object supporting
    COLUMN slices ``x[:, lo:hi]`` (numpy array, ``np.memmap``, HDF5
    dataset...). Column chunks stream host->device exactly TWICE:

    - pass 1 accumulates the small snapshot Gram H = X X^T
      (n_snap, n_snap) on device;
    - ``eigh(H)`` gives the right singular structure: sigma_i =
      sqrt(lambda_i), and the mode weights come FREE as
      W = X Phi = V Sigma (no third pass);
    - pass 2 assembles the spatial modes Phi = X^T V Sigma^{-1}
      chunk-by-chunk ((n_points, n_modes) must fit on device — the same
      bound as the fitted model itself).

    Returns a fitted ``models.pod.PodI`` (same predict surface; modes
    span the identical subspace as the RSVD-based in-memory fit — parity
    tested at prediction level). The exogenous-variable RBF interpolation
    is identical to the in-memory path. 2 total passes, deterministic
    (the snapshot Gram is exact — no sketch).
    """
    from corrla_rs_tpu.models.pod import PodI

    shape, dtype = _source_meta(x)
    if len(shape) != 2:
        raise ValueError(f"x must be 2-D (n_snapshots, n_points), got {shape}")
    n_snap, n_pts = shape
    t = jnp.asarray(t)
    if t.shape[0] != n_snap:
        raise ValueError(
            f"t rows ({t.shape[0]}) must match snapshot rows ({n_snap})"
        )
    r = min(int(n_modes), n_snap)
    if block_cols is None:
        block_cols = max(64, int(512e6 / max(
            n_snap * jnp.dtype(dtype).itemsize, 1)))
        block_cols = min(n_pts, block_cols)

    # pass 1: snapshot Gram (double buffered, bounded in-flight)
    h = jnp.zeros((n_snap, n_snap), dtype)
    pending = None
    for i, blk in _iter_col_blocks(x, n_pts, block_cols):
        dev_blk = jax.device_put(blk)
        if pending is not None:
            h = _acc_snapshot_gram(h, pending)
        dev_blk.block_until_ready()
        pending = dev_blk
    if pending is not None:
        h = _acc_snapshot_gram(h, pending)

    lam, v = jnp.linalg.eigh(h)
    lam = lam[::-1]
    v = v[:, ::-1]
    sig = jnp.sqrt(jnp.maximum(lam[:r], jnp.asarray(1e-30, dtype)))
    vs = v[:, :r] / sig[None, :]       # X^T vs = orthonormal modes
    weights = v[:, :r] * sig[None, :]  # X Phi == V Sigma, exactly

    # pass 2: spatial modes, chunkwise
    mode_blocks = []
    pending = None
    for i, blk in _iter_col_blocks(x, n_pts, block_cols):
        dev_blk = jax.device_put(blk)
        if pending is not None:
            mode_blocks.append(_modes_chunk(pending, vs))
        dev_blk.block_until_ready()
        pending = dev_blk
    if pending is not None:
        mode_blocks.append(_modes_chunk(pending, vs))
    modes = jnp.concatenate(mode_blocks, axis=0)[:n_pts]

    from corrla_rs_tpu.ops.interp import rbf_fit
    from corrla_rs_tpu.utils.config import PodConfig

    model = PodI.__new__(PodI)
    cfg = PodConfig()
    model._n_iter = int(cfg.n_iter)
    model._n_oversamples = int(cfg.n_oversamples)
    model._mesh = None
    model.n_snapshots = n_snap
    model.n_modes = r
    model.t_abscissa = t
    model.modes = modes
    model.mode_weights = weights
    model._rbf_coeffs = rbf_fit(t, weights, "linear", 1.0, 1)
    return model


@jax.jit
def _acc_time_gram(h, blk):
    """H += X_b^T X_b for a spatial (row) chunk of the (n_x, n_t)
    snapshot matrix — zero-padded rows contribute nothing."""
    return h + jnp.matmul(blk.T, blk, precision=PRECISION)


@jax.jit
def _dmdc_tall_chunk(blk, v_in_s, v_out_s, k_mat):
    """Per-block tall factors: rows of U_hat = X' V_hat S_hat^-1 and of
    the mode prefactor X' V~ S~^-1 (U~1^T U_hat)."""
    xp = blk[:, 1:]
    u_hat_blk = jnp.matmul(xp, v_out_s, precision=PRECISION)
    tm_blk = jnp.matmul(
        jnp.matmul(xp, v_in_s, precision=PRECISION), k_mat,
        precision=PRECISION,
    )
    return u_hat_blk, tm_blk


def _top_eigh_desc(g, r, dtype):
    """(sigma, V) of the top-r singular structure from an eigh of the
    (m, m) Gram, descending, with a RELATIVE rank cutoff on the inverse:
    directions below ~sqrt(eps)*sigma_max are numerically unresolved by
    the squared Gram and their 1/sigma would amplify rounding junk into
    the reduced operators (same failure class as _chol_qr_cols)."""
    lam, v = jnp.linalg.eigh(g)
    lam = lam[::-1][:r]
    v = v[:, ::-1][:, :r]
    sig = jnp.sqrt(jnp.maximum(lam, jnp.asarray(0.0, dtype)))
    cut = (1e-7 if dtype == jnp.float64 else 1e-4) * jnp.max(sig)
    sig_inv = jnp.where(sig > cut, 1.0 / jnp.maximum(sig, 1e-300), 0.0)
    return sig, sig_inv, v


def streamed_dmdc(x, u, n_modes: int, block_rows: int | None = None,
                  dt: float | None = None):
    """Out-of-core DMDc: state dimensions larger than device memory, via
    the method of snapshots. Completes the streaming ROM family
    (streamed_pca / streamed_pod / streamed_hosvd) for the controlled-
    dynamics model (reference dmd_rom.rs:20-225, whose only scale limit
    is host RAM).

    x: (n_x, n_t) snapshot columns with n_x huge — any object supporting
    ROW slices ``x[lo:hi]`` (numpy array, ``np.memmap``, HDF5 dataset,
    ``RowBlockSource``...). u: (n_u, n_t) control columns — small, in
    memory. Row chunks stream host->device exactly TWICE:

    - pass 1 accumulates the small time-axis Gram H = X^T X
      (n_t, n_t) on device. Every reduced quantity of the Proctor/
      Brunton/Kutz algebra is a submatrix function of H: the input-space
      Gram is Omega^T Omega = H[:-1, :-1] + U1^T U1, the output-space
      Gram is H[1:, 1:], and the cross term X1^T X' = H[:-1, 1:], so
      both SVDs (via eigh of the Grams) and A~ (eq. 29) / B~ (eq. 30)
      cost no further passes;
    - pass 2 assembles the tall factors chunk-by-chunk: U_hat
      (n_x, r), the eq. 36 mode prefactor (n_x, r), and B = U_hat B~.
      These (n_x, r) factors must fit on device — the same bound as the
      fitted model itself.

    Returns a fitted ``models.dmd.DMDc`` (same predict surface). The
    snapshot SVDs here are EXACT (deterministic Gram eigh — no sketch),
    so at equal n_modes the fit is at least as accurate as the in-memory
    randomized path; singular directions below ~sqrt(eps)*sigma_max are
    unresolvable through the squared Gram and are rank-cut out of the
    reduced operators (the randomized path resolves them — at these
    scales they carry no signal).
    """
    from corrla_rs_tpu.models.dmd import DMDc, _dmdc_modes_kernel, \
        _pinv_complex_np
    from corrla_rs_tpu.ops.eig import eig_host
    from corrla_rs_tpu.utils.config import DmdConfig

    shape, dtype = _source_meta(x)
    if len(shape) != 2:
        raise ValueError(f"x must be 2-D (n_x, n_t), got {shape}")
    n_x, n_t = shape
    u = jnp.asarray(u)
    if u.ndim != 2 or u.shape[1] != n_t:
        raise ValueError(
            f"u must be (n_u, n_t={n_t}), got {tuple(u.shape)}"
        )
    n_u = u.shape[0]
    m = n_t - 1
    r = min(int(n_modes), m)
    if block_rows is None:
        block_rows = _default_block_rows(n_x, n_t, dtype)

    # pass 1: time-axis Gram
    h = _stream_accumulate(
        x, n_x, block_rows, jnp.zeros((n_t, n_t), dtype),
        lambda acc, blk, _i: _acc_time_gram(acc, blk),
    )

    # reduced algebra — all (m, m)-sized or smaller, on device
    u1 = u[:, :m].astype(dtype)
    g_in = h[:m, :m] + jnp.matmul(u1.T, u1, precision=PRECISION)
    g_out = h[1:, 1:]
    cross = h[:m, 1:]                      # X1^T X'
    s_in, s_in_inv, v_in = _top_eigh_desc(g_in, r, dtype)
    s_out, s_out_inv, v_out = _top_eigh_desc(g_out, r, dtype)
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    v_in_s = v_in * s_in_inv[None, :]      # V~ S~^-1   (m, r)
    v_out_s = v_out * s_out_inv[None, :]   # V^ S^^-1   (m, r)
    # U~1^T U_hat = S~^-1 V~^T (X1^T X') V^ S^^-1    (r, r)
    k_mat = mm(mm(v_in_s.T, cross), v_out_s)
    # U_hat^T X' V~ S~^-1 = S^ V^^T V~ S~^-1         (r, r)
    tmp_op_scale = s_out[:, None] * mm(v_out.T, v_in_s)
    a_til = mm(tmp_op_scale, k_mat)                      # eq. 29
    u_til_2 = mm(u1, v_in_s)                             # (n_u, r)
    b_til = mm(tmp_op_scale, u_til_2.T)                  # eq. 30

    # pass 2: tall factors
    def tall_step(acc, blk, _i):
        uh_blocks, tm_blocks = acc
        uh_blk, tm_blk = _dmdc_tall_chunk(blk, v_in_s, v_out_s, k_mat)
        return uh_blocks + [uh_blk], tm_blocks + [tm_blk]

    uh_blocks, tm_blocks = _stream_accumulate(
        x, n_x, block_rows, ([], []), tall_step
    )
    u_hat = jnp.concatenate(uh_blocks, axis=0)[:n_x]
    tmp_modes_scale = jnp.concatenate(tm_blocks, axis=0)[:n_x]
    b_op = mm(u_hat, b_til)

    # host r x r eigensolve + eq. 36 modes (same chain as the DMDc
    # constructor's host path)
    lam, w = eig_host(a_til)
    modes_re, modes_im = _dmdc_modes_kernel(
        tmp_modes_scale,
        jnp.asarray(np.real(w), dtype),
        jnp.asarray(np.imag(w), dtype),
    )

    model = DMDc.__new__(DMDc)
    model.n_snapshots = n_t
    model.n_x = n_x
    model.n_u = n_u
    model.n_modes = r
    model.dt_snapshots = float(dt if dt is not None else DmdConfig().dt)
    model._A = a_til
    model._B = b_op
    model._u_hat = u_hat
    model.lambdas = lam
    model.modes_re, model.modes_im = modes_re, modes_im
    model._a_full = None
    both = np.asarray(jnp.stack([modes_re, modes_im]))
    phi = both[0] + 1j * both[1]
    wfac = lam[:, None] * _pinv_complex_np(phi)
    model._w_re = jnp.asarray(np.real(wfac), dtype)
    model._w_im = jnp.asarray(np.imag(wfac), dtype)
    return model
