"""On-device nonsymmetric eigendecomposition (real Schur QR algorithm).

The reference's complex eigensolve (dmd_rom.rs:112-125, faer
``Eigendecomposition<c64>``) runs on host LAPACK between jitted stages
(ops/eig.eig_host) or through a host callback. This module removes that
host step with a pure-JAX implementation that is **jit-safe, vmap-able, and complex-free**
(eigenvalues and eigenvectors are returned as separate real/imaginary
parts, so it runs on backends with no complex dtype support at all):

- ``hessenberg``: Householder reduction to upper Hessenberg form.
- ``schur``: real Schur form via the implicit Francis double-shift QR
  algorithm with bulge chasing — the same algorithm family as LAPACK's
  ``dlahqr``, re-expressed with static shapes (masked active window,
  ``lax.while_loop`` over sweeps, ``lax.fori_loop`` bulge chase) so XLA
  can compile it for any backend.
- ``eigvals``: eigenvalues of the quasi-triangular Schur factor (1x1
  blocks directly, 2x2 blocks via the quadratic formula).
- ``eig_device``: eigenvalues + right eigenvectors; eigenvectors via two
  rounds of batched inverse iteration, solving the complex system
  (A - lambda I) v = b through its real 2n x 2n embedding
  [[A - re(l) I, im(l) I], [-im(l) I, A - re(l) I]] with one batched LU.

Intended regime: the small dense matrices this library actually
eigensolves (DMDc's r x r reduced operator, r <= a few hundred). The QR
iteration is sequential (O(n) sweeps of O(n) chase steps), so a single
eager call is slower than host LAPACK — its value is *composability*:
it runs inside jit/pjit pipelines with no host sync, and under ``vmap``
the whole iteration batches, making B eigendecompositions cost roughly
one (bootstrap DMD spectra, parameter sweeps).

``eigvals_device``/``eig_device`` apply exact power-of-two diagonal
balancing by default (LAPACK xGEBAL's diagonal stage, parallelized) —
on a 12-orders-of-magnitude graded similarity the unbalanced QR
iteration is completely wrong (rel err ~1e3) while the balanced one is
machine-exact (3e-15, measured).

Clustered/multiple eigenvalues: inverse iteration alone returns
nearly-identical vectors for every member of an eigenvalue cluster (the
xHSEIN caveat). Here each solve round is followed by a masked
Gram-Schmidt among cluster members (``_cluster_orthogonalize``), so a
semisimple multiple eigenvalue comes back with an orthonormal basis of
its eigenspace (property-tested over multiplicity-2/3 spectra). For a
DEFECTIVE eigenvalue no such basis exists; the returned vectors then
span the dominant invariant subspace.

Known limits (documented, tested): eigenvalues of a non-normal matrix
are obtained to ~eps*||A||*cond accuracy like any QR method.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["hessenberg", "schur", "eigvals_device", "eig_device"]


def _eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


# ---------------------------------------------------------------------------
# Hessenberg reduction
# ---------------------------------------------------------------------------

@jax.jit
def hessenberg(a: jnp.ndarray):
    """Reduce a real square matrix to upper Hessenberg form.

    Returns ``(h, q)`` with ``q @ h @ q.T == a`` and ``q`` orthogonal.
    Householder reflectors under a ``fori_loop`` (one per column, applied
    as rank-1 updates so the loop body is all matmul-class work).
    """
    n = a.shape[-1]
    dtype = a.dtype
    if n <= 2:
        return a, jnp.eye(n, dtype=dtype)
    idx = jnp.arange(n)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def body(k, carry):
        h, q = carry
        col = h[:, k]
        xm = jnp.where(idx >= k + 1, col, 0)
        sigma = jnp.linalg.norm(xm)
        x1 = col[k + 1]
        sign = jnp.where(x1 >= 0, 1.0, -1.0).astype(dtype)
        alpha = -sign * sigma
        e = (idx == k + 1).astype(dtype)
        v = xm - alpha * e
        vn = jnp.linalg.norm(v)
        v = jnp.where(vn > tiny, v / jnp.maximum(vn, tiny), 0.0)
        # P = I - 2 v v^T ; similarity P H P and accumulation Q P
        h = h - 2.0 * jnp.outer(v, jnp.matmul(v, h))
        h = h - 2.0 * jnp.outer(jnp.matmul(h, v), v)
        q = q - 2.0 * jnp.outer(jnp.matmul(q, v), v)
        return h, q

    h, q = lax.fori_loop(0, n - 2, body, (a, jnp.eye(n, dtype=dtype)))
    # enforce exact Hessenberg structure (below-subdiagonal entries are
    # O(eps) arithmetic residue of the reflector applications)
    h = jnp.where(idx[:, None] <= idx[None, :] + 1, h, 0.0)
    return h, q


# ---------------------------------------------------------------------------
# Francis double-shift QR -> real Schur form
# ---------------------------------------------------------------------------

def _house3(x, y, z, dtype):
    """3-element Householder: returns (v, beta) with P = I - beta v v^T
    mapping [x, y, z] to [~, 0, 0]. Degenerates cleanly: z == 0 gives
    v[2] == 0 (P leaves the third row/column alone); x=y=z=0 gives P = I.
    """
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    # scale to avoid overflow in the squares
    scale = jnp.maximum(jnp.abs(x) + jnp.abs(y) + jnp.abs(z), tiny)
    xs, ys, zs = x / scale, y / scale, z / scale
    s = jnp.sqrt(xs * xs + ys * ys + zs * zs)
    sign = jnp.where(xs >= 0, 1.0, -1.0).astype(dtype)
    alpha = -sign * s
    v0 = xs - alpha
    v = jnp.stack([v0, ys, zs])
    vn2 = jnp.sum(v * v)
    beta = jnp.where(vn2 > tiny, 2.0 / jnp.maximum(vn2, tiny), 0.0)
    return v, beta


@functools.partial(jax.jit, static_argnames=("max_iters",))
def schur(a: jnp.ndarray, max_iters: int | None = None):
    """Real Schur decomposition ``a = q @ t @ q.T`` (q orthogonal, t
    quasi-upper-triangular with 1x1 and 2x2 diagonal blocks).

    Implicit Francis double-shift QR with bulge chasing on the Hessenberg
    form, static shapes throughout: the active window [lo..p] is tracked
    as integers in the ``while_loop`` carry, reflectors are applied as
    3-row/3-column dynamic-slice updates on arrays padded by 2 (so the
    chase needs no boundary special-casing — beyond-window reads are
    structural zeros and the reflector's third component degenerates to
    zero there). Exceptional shifts every 10 stalled sweeps break the
    rare cycles, exactly like LAPACK dlahqr.

    2x2 diagonal blocks are left unstandardized: a terminal 2x2 window is
    accepted as a block whether its eigenvalues are real or complex
    (``eigvals_device`` resolves both via the quadratic formula). This is
    the only deviation from the LAPACK convention (which splits real
    pairs), and it does not affect eigenvalues, similarity, or
    quasi-triangularity.

    Returns ``(t, q, converged)``; ``converged`` is a scalar bool (False
    only if ``max_iters`` sweeps did not deflate every eigenvalue — the
    documented LAPACK-style failure mode, vanishingly rare with
    exceptional shifts).
    """
    n = a.shape[-1]
    dtype = a.dtype
    if n == 1:
        return a, jnp.ones((1, 1), dtype), jnp.asarray(True)
    eps = _eps(dtype)
    if max_iters is None:
        max_iters = 40 * n

    # pre-scale so squares in shift/reflector arithmetic cannot overflow
    anorm = jnp.max(jnp.abs(a))
    safe = jnp.maximum(anorm, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    h0, q0 = hessenberg(a / safe)

    if n == 2:
        t = h0 * safe
        return t, q0, jnp.asarray(True)

    n2 = n + 2
    hp = jnp.zeros((n2, n2), dtype).at[:n, :n].set(h0)
    qp = jnp.zeros((n, n2), dtype).at[:, :n].set(q0)
    idx = jnp.arange(n2)
    hess_mask = idx[:, None] <= idx[None, :] + 1

    def chase_sweep(hp, qp, lo, p, sx, sy, sz):
        """One implicit double-shift sweep on window [lo..p] (size >= 3).

        The k-loop runs over FIXED bounds [0, n-2) with out-of-window
        steps masked to identity reflectors (beta = 0) instead of dynamic
        [lo, p) bounds: under vmap, dynamic bounds make k differ per
        batch element, turning every 3-row dynamic_slice into a batched
        gather/scatter; the uniform-k version hits the same slices across
        the batch, so it stays plain slices when batched, at ~2x the
        arithmetic for a single matrix (the masked steps are wasted work
        there).
        """

        z0 = jnp.int32(0)

        def step(k, carry):
            hp, qp = carry
            first = k == lo
            x = jnp.where(first, sx, hp[k, k - 1])
            y = jnp.where(first, sy, hp[k + 1, k - 1])
            z = jnp.where(first, sz, hp[k + 2, k - 1])
            v, beta = _house3(x, y, z, dtype)
            beta = jnp.where((k >= lo) & (k < p), beta, 0.0)
            # left: rows k..k+2 over all columns
            rows = lax.dynamic_slice(hp, (k, z0), (3, n2))
            rows = rows - beta * jnp.outer(v, jnp.matmul(v, rows))
            hp = lax.dynamic_update_slice(hp, rows, (k, z0))
            # right: columns k..k+2 over all rows
            cols = lax.dynamic_slice(hp, (z0, k), (n2, 3))
            cols = cols - beta * jnp.outer(jnp.matmul(cols, v), v)
            hp = lax.dynamic_update_slice(hp, cols, (z0, k))
            qc = lax.dynamic_slice(qp, (z0, k), (n, 3))
            qc = qc - beta * jnp.outer(jnp.matmul(qc, v), v)
            qp = lax.dynamic_update_slice(qp, qc, (z0, k))
            return hp, qp

        hp, qp = lax.fori_loop(
            jnp.int32(0), jnp.int32(n - 1), step, (hp, qp)
        )
        # the chase leaves O(eps) arithmetic residue below the subdiagonal
        hp = jnp.where(hess_mask, hp, 0.0)
        return hp, qp

    def cond(carry):
        _hp, _qp, hi, it, _stall = carry
        return (hi >= 1) & (it < max_iters)

    def body(carry):
        hp, qp, hi, it, stall = carry
        p = hi
        d = jnp.abs(jnp.diagonal(hp))           # (n2,)
        sub = jnp.abs(jnp.diagonal(hp, -1))     # (n2-1,) sub[i] = |h[i+1, i]|
        # Ahues-Tisseur-style negligibility for subdiagonal i+1 <- i, with
        # an eps floor (h is pre-scaled to ~unit norm)
        thr = eps * jnp.maximum(d[:-1] + d[1:], 0.1)
        neg = sub <= thr                        # neg[i]: h[i+1, i] negligible
        # lo = largest block start l <= p with h[l, l-1] negligible (0 if none)
        i1 = jnp.arange(1, n2, dtype=jnp.int32)
        cand = jnp.where((i1 <= p) & neg, i1, jnp.int32(0))
        lo = jnp.max(cand)

        win = p - lo + 1

        def deflate_one(args):
            hp, qp, stall = args
            hp = hp.at[p, p - 1].set(0.0)
            return hp, qp, p - 1, jnp.int32(0)

        def deflate_two(args):
            hp, qp, stall = args
            hp = jnp.where(lo >= 1, hp.at[lo, lo - 1].set(0.0), hp)
            return hp, qp, lo - 1, jnp.int32(0)

        def sweep(args):
            hp, qp, stall = args
            hp = jnp.where(lo >= 1, hp.at[lo, lo - 1].set(0.0), hp)
            # Francis shift from the trailing 2x2 of the window
            h11 = hp[p - 1, p - 1]
            h12 = hp[p - 1, p]
            h21 = hp[p, p - 1]
            h22 = hp[p, p]
            s = h11 + h22
            t = h11 * h22 - h12 * h21
            # exceptional shift every 10 stalled sweeps (dlahqr-style)
            exc = (stall > 0) & (stall % 10 == 0)
            s1 = 0.75 * jnp.abs(h21) + h22
            s = jnp.where(exc, 2.0 * s1, s)
            t = jnp.where(exc, s1 * s1, t)
            a00 = hp[lo, lo]
            a01 = hp[lo, lo + 1]
            a10 = hp[lo + 1, lo]
            a11 = hp[lo + 1, lo + 1]
            a21 = hp[lo + 2, lo + 1]
            sx = a00 * a00 + a01 * a10 - s * a00 + t
            sy = a10 * (a00 + a11 - s)
            sz = a10 * a21
            hp, qp = chase_sweep(hp, qp, lo, p, sx, sy, sz)
            return hp, qp, p, stall + jnp.int32(1)

        hp, qp, hi, stall = lax.cond(
            win == 1,
            deflate_one,
            lambda args: lax.cond(win == 2, deflate_two, sweep, args),
            (hp, qp, stall),
        )
        return hp, qp, hi, it + jnp.int32(1), stall

    hp, qp, hi, _it, _stall = lax.while_loop(
        cond,
        body,
        (hp, qp, jnp.int32(n - 1), jnp.int32(0), jnp.int32(0)),
    )
    converged = hi < 1
    t = hp[:n, :n]
    # zero any remaining negligible subdiagonals (deflation only zeroes the
    # entry it split at; others may hold O(eps) residue that
    # _eigvals_from_schur would misread as 2x2 blocks)
    d = jnp.abs(jnp.diagonal(t))
    sub = jnp.diagonal(t, -1)
    neg = jnp.abs(sub) <= eps * jnp.maximum(d[:-1] + d[1:], 0.1)
    sub_mask = jnp.zeros((n, n), bool).at[jnp.arange(1, n), jnp.arange(n - 1)
                                          ].set(neg)
    t = jnp.where(sub_mask, 0.0, t) * safe
    q = qp[:, :n]
    return t, q, converged


# ---------------------------------------------------------------------------
# Eigenvalues from the quasi-triangular factor
# ---------------------------------------------------------------------------

@jax.jit
def _eigvals_from_schur(t: jnp.ndarray):
    """(lam_re, lam_im) from a quasi-upper-triangular matrix: 1x1 blocks
    directly, 2x2 blocks (identified by a nonzero subdiagonal entry) via
    the quadratic formula (real roots when the discriminant is >= 0,
    conjugate pair otherwise)."""
    n = t.shape[-1]
    dtype = t.dtype
    d = jnp.diagonal(t)
    if n == 1:
        return d, jnp.zeros_like(d)
    sub = jnp.diagonal(t, -1)                      # sub[i] = t[i+1, i]
    is_start = jnp.concatenate([sub != 0, jnp.zeros((1,), bool)])
    # a block start cannot immediately follow another block start
    prev = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])
    is_start = is_start & ~prev
    is_second = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])

    up = jnp.concatenate([jnp.diagonal(t, 1), jnp.zeros((1,), dtype)])
    dn = jnp.concatenate([d[1:], jnp.zeros((1,), dtype)])
    sb = jnp.concatenate([sub, jnp.zeros((1,), dtype)])
    # block at i: [[d_i, up_i], [sb_i, dn_i]]
    m = 0.5 * (d + dn)
    disc = 0.25 * (d - dn) ** 2 + up * sb
    root = jnp.sqrt(jnp.abs(disc))
    real_pair = disc >= 0

    lam_re_start = jnp.where(real_pair, m + root, m)
    lam_im_start = jnp.where(real_pair, 0.0, root)
    lam_re_secnd = jnp.where(real_pair, m - root, m)
    lam_im_secnd = jnp.where(real_pair, 0.0, -root)

    # shift the "second" values down one slot to land on index i+1
    lam_re_secnd = jnp.concatenate([d[:1] * 0, lam_re_secnd[:-1]])
    lam_im_secnd = jnp.concatenate([d[:1] * 0, lam_im_secnd[:-1]])

    lam_re = jnp.where(is_start, lam_re_start,
                       jnp.where(is_second, lam_re_secnd, d))
    lam_im = jnp.where(is_start, lam_im_start,
                       jnp.where(is_second, lam_im_secnd, 0.0))
    return lam_re, lam_im


def _balance(a: jnp.ndarray, n_sweeps: int = 5):
    """Diagonal balancing D^-1 A D (LAPACK xGEBAL's diagonal stage,
    parallelized): equalize off-diagonal row/column 1-norms with
    power-of-two scale factors (exact in binary floating point, so
    balancing itself introduces NO rounding error). Graded matrices —
    entries spanning many orders of magnitude — lose eigenvalue accuracy
    in the QR iteration roughly as the grading ratio; balancing restores
    it. Returns ``(a_balanced, d)`` with ``a = diag(d) a_b diag(1/d)``.
    """
    n = a.shape[-1]
    off = 1.0 - jnp.eye(n, dtype=a.dtype)

    def sweep(_i, carry):
        ab, d = carry
        absa = jnp.abs(ab) * off
        r = jnp.sum(absa, axis=1)        # row norms
        c = jnp.sum(absa, axis=0)        # col norms
        ok = (r > 0) & (c > 0)
        f = jnp.where(ok, jnp.sqrt(jnp.where(ok, r / jnp.maximum(c, 1e-300),
                                             1.0)), 1.0)
        # round to the nearest power of two, clamped: exact rescaling only
        f = jnp.exp2(jnp.clip(jnp.round(jnp.log2(f)), -32, 32))
        # rows / f, cols * f
        ab = ab / f[:, None] * f[None, :]
        return ab, d * f

    ones = jnp.ones((n,), a.dtype)
    ab, d = lax.fori_loop(0, n_sweeps, sweep, (a, ones))
    return ab, d


def eigvals_device(a: jnp.ndarray, max_iters: int | None = None,
                   balance: bool = True):
    """Eigenvalues of a real square matrix as ``(lam_re, lam_im)`` real
    arrays — fully on-device, jit/vmap-safe (complex-free). Pair with
    ``eig_device`` when eigenvectors are needed.

    balance=True (default, like LAPACK xGEEV) applies exact power-of-two
    diagonal balancing before the QR iteration — essential for graded
    matrices (entries spanning orders of magnitude), free otherwise.

    A (B, n, n) stack is vmapped automatically.
    """
    a = jnp.asarray(a)
    if a.ndim == 3:
        return _batched_eigvals(max_iters, balance)(a)
    if balance:
        a, _d = _balance(jnp.asarray(a))
    t, _q, ok = schur(a, max_iters=max_iters)
    lam_re, lam_im = _eigvals_from_schur(t)
    # non-convergence (max_iters exhausted) must not return plausible
    # garbage: poison the outputs with NaN so callers (and the debug/
    # NaN-check mode) see a loud failure instead of silently wrong
    # spectra — raising is impossible under jit
    nan = jnp.asarray(jnp.nan, lam_re.dtype)
    return jnp.where(ok, lam_re, nan), jnp.where(ok, lam_im, nan)


# ---------------------------------------------------------------------------
# Eigenvectors via batched inverse iteration (real embedding of C^n)
# ---------------------------------------------------------------------------

def _cluster_orthogonalize(vr, vi, lam_re, lam_im, thr):
    """Masked modified Gram-Schmidt among eigenvalue-cluster members.

    ``vr``/``vi`` hold eigenvector j in ROW j. For each j (sequentially),
    subtract the complex projections onto every EARLIER vector whose
    eigenvalue lies within ``thr`` of lambda_j. Inverse iteration returns
    nearly-identical vectors for clustered eigenvalues (they all align
    with the cluster subspace's dominant direction); orthogonalizing
    between solve rounds re-seeds each later member with the orthogonal
    complement, which the next solve amplifies back into the cluster's
    invariant subspace — yielding an orthonormal basis of it (the best
    any method can do for a multiple eigenvalue; for a defective cluster
    the basis spans the dominant invariant subspace instead).
    """
    n = vr.shape[0]
    d2 = (lam_re[:, None] - lam_re[None, :]) ** 2 + (
        lam_im[:, None] - lam_im[None, :]
    ) ** 2
    close = d2 <= thr * thr
    idx = jnp.arange(n)
    tiny = jnp.asarray(jnp.finfo(vr.dtype).tiny, vr.dtype)

    def body(j, carry):
        vr, vi = carry
        mask = (close[:, j] & (idx < j)).astype(vr.dtype)   # (n,)
        # complex coefficients c_i = <v_i, v_j> (rows of vr/vi)
        cr = (jnp.matmul(vr, vr[j]) + jnp.matmul(vi, vi[j])) * mask
        ci = (jnp.matmul(vr, vi[j]) - jnp.matmul(vi, vr[j])) * mask
        new_r = vr[j] - (jnp.matmul(cr, vr) - jnp.matmul(ci, vi))
        new_i = vi[j] - (jnp.matmul(cr, vi) + jnp.matmul(ci, vr))
        nrm = jnp.sqrt(jnp.sum(new_r * new_r + new_i * new_i))
        scale = 1.0 / jnp.maximum(nrm, tiny)
        return vr.at[j].set(new_r * scale), vi.at[j].set(new_i * scale)

    return lax.fori_loop(0, n, body, (vr, vi))


@jax.jit
def _inverse_iteration(a, lam_re, lam_im):
    n = a.shape[-1]
    dtype = a.dtype
    eps = _eps(dtype)
    anorm = jnp.maximum(jnp.max(jnp.abs(a)), jnp.asarray(1.0, dtype))
    # perturb the shift off exact singularity (xHSEIN does the same): an
    # O(eps ||A||) relative shift changes the eigenvector by O(eps/gap).
    # The per-row jitter (2 + j) keeps EXACT duplicate eigenvalues from
    # producing bit-identical singular systems (observed: LU zero pivot
    # -> inf - inf -> NaN on an exact multiplicity-2 symmetric spectrum).
    delta = eps * anorm * (2.0 + jnp.arange(n, dtype=dtype) % 7.0)
    lr = lam_re + delta

    eye = jnp.eye(n, dtype=dtype)

    def embed(lr_j, li_j):
        # (A - l I)(vr + i vi) = b  <=>  [[A-lr, li], [-li, A-lr]] [vr;vi]
        m11 = a - lr_j * eye
        m12 = li_j * eye
        top = jnp.concatenate([m11, m12], axis=1)
        bot = jnp.concatenate([-m12, m11], axis=1)
        return jnp.concatenate([top, bot], axis=0)

    ms = jax.vmap(embed)(lr, lam_im)               # (n, 2n, 2n)

    # deterministic non-degenerate starts; imaginary part zeroed for real
    # eigenvalues so their eigenvectors come out real
    j = jnp.arange(n, dtype=dtype)
    i = jnp.arange(n, dtype=dtype)
    br = jnp.sin(1.7 * i[None, :] + 0.9 * j[:, None] + 0.3)
    bi = jnp.cos(1.3 * i[None, :] + 0.7 * j[:, None] + 0.1)
    bi = jnp.where((lam_im == 0)[:, None], 0.0, bi)
    b = jnp.concatenate([br, bi], axis=1)          # (n, 2n)

    def normalize(v):
        vr, vi = v[:, :n], v[:, n:]
        nrm = jnp.sqrt(jnp.sum(vr * vr + vi * vi, axis=1, keepdims=True))
        nrm = jnp.maximum(nrm, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
        return v / nrm

    def solve_step(v):
        """One shifted solve with scrub: rows whose (near-singular)
        system overflowed to non-finite keep their previous iterate."""
        sol = jnp.linalg.solve(ms, normalize(v)[..., None])[..., 0]
        sol = sol / jnp.maximum(
            jnp.max(jnp.abs(sol), axis=1, keepdims=True),
            jnp.asarray(jnp.finfo(dtype).tiny, dtype),
        )
        ok = jnp.all(jnp.isfinite(sol), axis=1, keepdims=True)
        return jnp.where(ok, sol, normalize(v))

    # eigenvalue-cluster radius, RELATIVE to the eigenvalue magnitudes
    # (an absolute ||A||-scaled radius would lump every small eigenvalue
    # of a graded spectrum into one bogus cluster), floored near zero at
    # the QR-split scale of a multiple zero eigenvalue
    lam_mag = jnp.sqrt(lam_re**2 + lam_im**2)
    scale_ij = jnp.maximum(
        jnp.maximum(lam_mag[:, None], lam_mag[None, :]),
        jnp.sqrt(eps) * anorm,
    )
    cluster_thr = 16.0 * jnp.sqrt(eps) * scale_ij

    def orth(v):
        # re-seed clustered eigenvectors with the orthogonal complement
        # before the next solve (and orthogonalize the final output):
        # without this, every member of an eigenvalue cluster collapses
        # onto the same dominant direction
        v = normalize(v)
        wr, wi = _cluster_orthogonalize(
            v[:, :n], v[:, n:], lam_re, lam_im, cluster_thr
        )
        return jnp.concatenate([wr, wi], axis=1)

    def resid(v):
        """Per-row eigen residual ||A v_j - lambda_j v_j||_2 (complex
        arithmetic in (re, im) parts; rows are vectors)."""
        vr, vi = v[:, :n], v[:, n:]
        ar = jnp.matmul(vr, a.T) - (lam_re[:, None] * vr
                                    - lam_im[:, None] * vi)
        ai = jnp.matmul(vi, a.T) - (lam_re[:, None] * vi
                                    + lam_im[:, None] * vr)
        return jnp.sqrt(jnp.sum(ar * ar + ai * ai, axis=1))

    # shared first solve; then a plain second round (the classic xHSEIN
    # behavior) and an orthogonalized one. Cluster orthogonalization is
    # only valid for SEMISIMPLE clusters (a defective eigenvalue has no
    # eigenbasis — forcing orthogonality there destroys the residual),
    # so each vector keeps the orthogonalized version only where its
    # residual stays small.
    v1 = solve_step(b)
    v_plain = normalize(solve_step(v1))
    v_orth = normalize(orth(solve_step(orth(v1))))
    r_plain = resid(v_plain)
    r_orth = resid(v_orth)
    accept = r_orth <= jnp.maximum(
        100.0 * r_plain, jnp.sqrt(eps) * anorm
    )
    v = jnp.where(accept[:, None], v_orth, v_plain)
    vr, vi = v[:, :n], v[:, n:]

    # fix the phase: rotate each vector so its largest-magnitude component
    # is real and positive (deterministic output; real eigenvectors stay
    # real up to sign)
    mag2 = vr * vr + vi * vi
    k = jnp.argmax(mag2, axis=1)
    pr = jnp.take_along_axis(vr, k[:, None], axis=1)
    pi = jnp.take_along_axis(vi, k[:, None], axis=1)
    pn = jnp.sqrt(pr * pr + pi * pi)
    pn = jnp.maximum(pn, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    cr, ci = pr / pn, -pi / pn                     # conj(phase)
    wr = cr * vr - ci * vi
    wi = cr * vi + ci * vr
    # columns are eigenvectors (numpy layout): transpose the batch axis
    return wr.T, wi.T


def eig_device(a: jnp.ndarray, max_iters: int | None = None,
               balance: bool = True):
    """Eigenvalues and right eigenvectors of a real square matrix, fully
    on-device and complex-free.

    Returns ``(lam_re, lam_im, v_re, v_im)`` with eigenvectors in columns
    (``v[:, j]`` belongs to ``lam[j]``, numpy layout), unit 2-norm, phase
    fixed so the largest component is real-positive. jit- and vmap-safe on
    every backend, with no host round trip, so it batches under vmap.

    Eigenvectors come from two rounds of inverse iteration against the
    Schur-derived eigenvalues, each round one batched 2n x 2n LU solve
    (the real embedding of the complex shifted system). For eigenvalue
    clusters tighter than ~eps*||A||/gap the returned vectors may be
    nearly dependent — the standard inverse-iteration caveat.

    A (B, n, n) stack is vmapped automatically.
    """
    a = jnp.asarray(a)
    if a.ndim == 3:
        return _batched_eig(max_iters, balance)(a)
    lam_re, lam_im = eigvals_device(a, max_iters=max_iters, balance=balance)
    # eigenvectors always come from inverse iteration on the ORIGINAL A
    # (balancing only sharpens the eigenvalue estimates feeding it)
    v_re, v_im = _inverse_iteration(a, lam_re, lam_im)
    return lam_re, lam_im, v_re, v_im


@functools.lru_cache(maxsize=32)
def _batched_eigvals(max_iters, balance):
    """Stable-identity jit(vmap) for (B, n, n) stacks — a fresh wrapper
    per call would re-trace every time (the pitfall models/dmd's
    _ensemble_fitter documents)."""
    return jax.jit(jax.vmap(
        lambda m: eigvals_device(m, max_iters=max_iters, balance=balance)
    ))


@functools.lru_cache(maxsize=32)
def _batched_eig(max_iters, balance):
    return jax.jit(jax.vmap(
        lambda m: eig_device(m, max_iters=max_iters, balance=balance)
    ))
