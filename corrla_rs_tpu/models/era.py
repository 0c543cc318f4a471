"""Eigensystem Realization Algorithm (ERA) — EXTENSION (no reference
analogue).

The reference's control-aware ROM is DMDc (dmd_rom.rs), which needs
FULL STATE snapshots. ERA (Juang & Pappa 1985; the discrete-time
sibling of balanced POD, see Ma-Ahuja-Rowley 2011) identifies a minimal
state-space realization (A, B, C) from INPUT-OUTPUT data only — the
impulse-response (Markov) parameters h_k = C A^k B — which is what an
experiment or a black-box solver actually provides. The realization is
balanced: its Hankel singular values rank state directions by
controllability*observability, giving the principled truncation order.

Accelerator shape: the block-Hankel matrices are ONE gather each
(an (mo, mc) index grid over the Markov stack — no Python loops), the
heavy step is a randomized SVD of H0 ((mo q), (mc p)) as dense matmuls, and
the realization itself is three small matmuls. Rollouts are lax.scan.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.checkpoint import register_model_class
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["Era", "era", "okid", "era_okid"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("mo", "mc", "rank",
                                             "n_iters", "n_os"))
def _era_kernel(markov, mo, mc, rank, n_iters, n_os, key):
    """(a, b, c, hsv) from the Markov stack (n_h, q, p).

    H0[i, j] = h_{i+j}, H1[i, j] = h_{i+j+1} (block indices, one gather
    each); randomized SVD of H0; balanced realization
    A = S^-1/2 U^T H1 V S^-1/2, B = S^1/2 V^T E_p, C = E_q^T U S^1/2.
    """
    q, p = markov.shape[1], markov.shape[2]
    idx = jnp.arange(mo)[:, None] + jnp.arange(mc)[None, :]
    # (mo, mc, q, p) -> (mo q, mc p)
    h0 = jnp.transpose(markov[idx], (0, 2, 1, 3)).reshape(mo * q, mc * p)
    h1 = jnp.transpose(markov[idx + 1], (0, 2, 1, 3)).reshape(
        mo * q, mc * p
    )
    u, s, vt = random_svd(h0, rank, n_iters, n_os, key=key)
    s_ih = 1.0 / jnp.sqrt(jnp.maximum(s, jnp.finfo(s.dtype).tiny))
    s_h = jnp.sqrt(s)
    a = (s_ih[:, None] * _mm(_mm(u.T, h1), vt.T)) * s_ih[None, :]
    b = s_h[:, None] * vt[:, :p]
    c = u[:q, :] * s_h[None, :]
    return a, b, c, s


@functools.partial(jax.jit, static_argnames=())
def _lti_rollout(a, b, c, x0, u_seq):
    """y (n_y, n_t) of x' = A x + B u, y = C x from inputs (n_u, n_t)."""
    def step(x, u_col):
        y = _mm(c, x[:, None])[:, 0]
        x_next = _mm(a, x[:, None])[:, 0] + _mm(b, u_col[:, None])[:, 0]
        return x_next, y

    _, ys = jax.lax.scan(step, x0, u_seq.T)
    return ys.T


@register_model_class
class Era:
    """Balanced state-space realization from impulse-response data
    (see :func:`era`).

    ``a``/``b``/``c`` — (r, r), (r, n_u), (n_y, r) realization in
    balanced coordinates; ``hsv`` — Hankel singular values (the order-
    selection diagnostic: truncate where they fall off); ``lambdas`` —
    complex host spectrum of A (the identified poles).
    """

    def truncate(self, order: int) -> "Era":
        """Balanced truncation to a smaller order WITHOUT re-fitting:
        ERA's realization is already balanced (controllability and
        observability Gramians equal and diagonal = hsv), so the
        optimal order-r reduction is the leading r x r block. The
        classic H-infinity error bound 2 * sum(hsv[r:]) holds in the
        limit of a long Markov window — ERA balances FINITE-horizon
        Gramians, so fit from a record long enough that the slowest
        pole's tail has decayed before trusting the bound."""
        r = int(order)
        if not 1 <= r <= self.order:
            raise ValueError(
                f"order must be in [1, {self.order}], got {order}"
            )
        out = Era.__new__(Era)
        out.order = r
        out.n_outputs, out.n_inputs = self.n_outputs, self.n_inputs
        out.a = self.a[:r, :r]
        out.b = self.b[:r, :]
        out.c = self.c[:, :r]
        out.hsv = self.hsv[:r]
        out.lambdas = np.linalg.eigvals(np.asarray(out.a, np.float64))
        d = getattr(self, "d", None)
        if d is not None:
            out.d = d
        return out

    def impulse_response(self, n_steps: int) -> jnp.ndarray:
        """(n_steps, n_y, n_u) Markov parameters of the realization:
        h_0 = C B, h_k = C A^k B."""
        n = int(n_steps)

        def step(ca, _):
            return _mm(ca, self.a), _mm(ca, self.b)

        _, hs = jax.lax.scan(step, self.c, None, length=n)
        return hs

    def predict(self, u_seq, x0=None) -> jnp.ndarray:
        """(n_y, n_t) response to inputs u_seq (n_u, n_t) from initial
        balanced state x0 (default 0). Convention: y_t = C x_t with
        x_0 given, x_{t+1} = A x_t + B u_t (so y_0 = C x0 and the
        first input affects y_1 — matching h_k = C A^{k-1} B... i.e.
        scipy.signal.dlsim's (A, B, C, 0) semantics)."""
        u = jnp.asarray(u_seq)
        if u.ndim == 1:
            u = u[None, :]
        if u.shape[0] != self.n_inputs:
            raise ValueError(
                f"u_seq must be ({self.n_inputs}, n_t), got {u.shape}"
            )
        if x0 is None:
            x0 = jnp.zeros((self.order,), self.a.dtype)
        else:
            x0 = jnp.asarray(x0).reshape(-1)
            if x0.shape[0] != self.order:
                raise ValueError(
                    f"x0 must have {self.order} entries, got {x0.shape}"
                )
        ys = _lti_rollout(self.a, self.b, self.c, x0, u)
        d = getattr(self, "d", None)   # feedthrough from era_okid
        return ys if d is None else ys + _mm(d, u)


def era(markov, rank: int, mo: int | None = None, mc: int | None = None,
        n_iters: int = 10, key=0, n_oversamples: int = 8) -> Era:
    """ERA fit from Markov parameters.

    markov: (n_h, n_y, n_u) impulse-response stack — ``markov[k]`` is
    the output response at step k+1 to a unit impulse at step 0
    (h_{k+1} = C A^k B; the k=0 feedthrough D is NOT part of the
    Hankel matrix and is identified separately if needed);
    rank: realization order r (inspect ``hsv`` to choose);
    mo / mc: block rows / columns of the Hankel matrix (default: split
    the available n_h as evenly as possible, using all data).
    """
    h = jnp.asarray(markov)
    if h.ndim == 2:
        h = h[:, :, None] if h.shape[1] != 1 else h[:, None, :]
    if h.ndim != 3:
        raise ValueError(
            f"markov must be (n_h, n_y, n_u), got {np.shape(markov)}"
        )
    n_h = int(h.shape[0])
    if mo is None and mc is None:
        mo = (n_h + 1) // 2
        mc = n_h - mo            # mo + mc = n_h; indices reach h[n_h-1]
    elif mo is None:
        mc = int(mc)
        mo = n_h - mc
    else:
        mo = int(mo)
        mc = n_h - mo if mc is None else int(mc)
    if mo < 1 or mc < 1 or mo + mc > n_h:
        raise ValueError(
            f"need mo, mc >= 1 with mo + mc <= n_h = {n_h}; got "
            f"mo={mo}, mc={mc}"
        )
    r = int(rank)
    q, p = int(h.shape[1]), int(h.shape[2])
    if not 1 <= r <= min(mo * q, mc * p):
        raise ValueError(
            f"rank must be in [1, min(mo*n_y, mc*n_u)] = "
            f"[1, {min(mo * q, mc * p)}], got {rank}"
        )
    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    (h,) = maybe_route_small(h)
    a, b, c, hsv = _era_kernel(h, mo, mc, r, int(n_iters),
                               int(n_oversamples), as_key(key))
    out = Era.__new__(Era)
    out.order = r
    out.n_outputs, out.n_inputs = q, p
    out.a, out.b, out.c = a, b, c
    out.hsv = hsv
    out.lambdas = np.linalg.eigvals(np.asarray(a, np.float64))
    return out


@functools.partial(jax.jit, static_argnames=("l",))
def _okid_lstsq(u, y, l, ridge):
    """Observer-Markov least squares: regressor rows for k = l..N-1 are
    [u_k; v_{k-1}; ...; v_{k-l}] with v_j = [u_j; y_j] — built by one
    gather over the stacked (p+q, N) record; the normal equations are
    two dense matmuls + one (small) solve."""
    p, n = u.shape
    q = y.shape[0]
    uy = jnp.concatenate([u, y], axis=0)              # (p+q, N)
    cols = jnp.arange(l, n)                           # regression times
    lags = jnp.arange(1, l + 1)
    idx = cols[None, :] - lags[:, None]               # (l, n-l)
    past = uy[:, idx]                                 # (p+q, l, n-l)
    past = jnp.transpose(past, (1, 0, 2)).reshape(l * (p + q), n - l)
    v = jnp.concatenate([u[:, l:], past], axis=0)     # (p + l(p+q), n-l)
    yl = y[:, l:]
    g = _mm(v, v.T)
    g = g + ridge * jnp.trace(g) / g.shape[0] * jnp.eye(
        g.shape[0], dtype=g.dtype
    )
    # M = Y V^T G^{-1}; G symmetric
    return jnp.linalg.solve(g, _mm(v, yl.T)).T        # (q, p + l(p+q))


def okid(u_data, y_data, n_markov: int, n_obs: int | None = None,
         ridge: float = 1e-10):
    """OKID (Juang-Phan-Horta-Longman 1991): system Markov parameters
    from an ARBITRARY input-output record — the step that turns
    operating data into the impulse response :func:`era` needs.

    u_data: (n_u, N) inputs; y_data: (n_y, N) outputs; n_markov: how
    many system Markov parameters h_1..h_{n_markov} to return; n_obs:
    observer depth l (default n_markov; the observer adds artificial
    damping so l only needs to exceed the system's effective memory);
    ridge: relative Tikhonov weight on the regressor Gram.

    Returns ``(markov, d)``: markov (n_markov, n_y, n_u) with
    ``markov[k] = h_{k+1} = C A^k B`` (feed directly to :func:`era`)
    and d (n_y, n_u) the feedthrough.
    """
    u = jnp.asarray(u_data)
    y = jnp.asarray(y_data)
    if u.ndim == 1:
        u = u[None, :]
    if y.ndim == 1:
        y = y[None, :]
    if u.ndim != 2 or y.ndim != 2 or u.shape[1] != y.shape[1]:
        raise ValueError(
            f"u_data/y_data must be (n_u, N)/(n_y, N) with equal N, "
            f"got {np.shape(u_data)} / {np.shape(y_data)}"
        )
    p, n = int(u.shape[0]), int(u.shape[1])
    q = int(y.shape[0])
    l = int(n_markov) if n_obs is None else int(n_obs)
    if not 1 <= l <= n - 1:
        raise ValueError(f"n_obs must be in [1, N-1], got {l}")
    if n - l <= p + l * (p + q):
        raise ValueError(
            f"record too short: need N - n_obs > n_u + n_obs*(n_u+n_y) "
            f"regression columns, got {n - l} <= {p + l * (p + q)}"
        )
    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    u, y = maybe_route_small(u, y)
    m = np.asarray(
        _okid_lstsq(u, y, l, jnp.asarray(ridge, u.dtype)), np.float64
    )
    d = m[:, :p]
    # observer Markov blocks: Mbar_i = [Mbar_i^(1) (q,p), Mbar_i^(2) (q,q)]
    m1 = np.empty((l, q, p))
    m2 = np.empty((l, q, q))
    for i in range(l):
        blk = m[:, p + i * (p + q): p + (i + 1) * (p + q)]
        m1[i] = blk[:, :p]
        m2[i] = blk[:, p:]
    # recursion: h_k = Mbar_k^(1) + Mbar_k^(2) D + sum_i Mbar_i^(2) h_{k-i}
    n_h = int(n_markov)
    h = np.zeros((n_h + 1, q, p))  # h[0] unused (h_0 = D kept separate)
    for k in range(1, n_h + 1):
        acc = (m1[k - 1] + m2[k - 1] @ d) if k <= l else np.zeros((q, p))
        for i in range(1, min(k, l + 1)):
            if k - i >= 1:
                acc = acc + m2[i - 1] @ h[k - i]
        h[k] = acc
    return h[1:], d


def era_okid(u_data, y_data, rank: int, n_markov: int | None = None,
             n_obs: int | None = None, ridge: float = 1e-10,
             **era_kwargs) -> Era:
    """Identify a balanced realization straight from operating data:
    :func:`okid` -> :func:`era`. The feedthrough lands on ``fit.d``
    and ``predict`` includes it."""
    y = np.asarray(y_data)
    u_arr = np.atleast_2d(np.asarray(u_data))
    y2 = np.atleast_2d(y)
    n = y2.shape[-1]
    p, q = u_arr.shape[0], y2.shape[0]
    # okid feasibility: the observer depth l must leave more regression
    # columns than unknowns, N - l > p + l (p + q)  =>
    # l < (N - p) / (p + q + 1); keep a 2x margin for a well-posed LS
    l_max = max(1, (n - p) // (2 * (p + q + 1)))
    if n_markov is None:
        n_markov = max(2, min(n // 4, 200, l_max))
    if n_obs is None:
        n_obs = min(int(n_markov), l_max)
    markov, d = okid(u_data, y_data, int(n_markov), n_obs=n_obs,
                     ridge=ridge)
    fit = era(markov, rank, **era_kwargs)
    fit.d = jnp.asarray(d, fit.a.dtype)
    return fit
