"""Optimized DMD (variable projection) and BOP-DMD — EXTENSION
(no reference analogue; the reference's ROM layer dmd_rom.rs only has
the one-step least-squares operator).

Exact DMD regresses a one-step map, which (a) biases the spectrum under
measurement noise (the noise enters the regressor X1), (b) requires
uniformly spaced snapshots, and (c) fits the operator, not the thing
usually wanted — the continuous-time spectral model
``x(t) ~= Re(Phi diag(b) exp(alpha t))``. Optimized DMD (Askham & Kutz
2018) fits that model DIRECTLY by nonlinear least squares over the
continuous eigenvalues alpha, with the linear parameters (modes x
amplitudes) eliminated by variable projection. It is unbiased to first
order in the noise, accepts arbitrary (unequal) sample times, and
forecasts at arbitrary real times. BOP-DMD (Sashidhar & Kutz 2022) bags
it over random time subsets for eigenvalue/mode/forecast uncertainty.

Accelerator shape: the only large-dimension work is the rank-r POD
projection (randomized SVD of the (n_x, m) snapshot matrix + one
(r, n_x)x(n_x, m) matmul) and the final mode lift U @ B^T. The
variable-projection Levenberg-Marquardt then runs on the PROJECTED
(m, r) complex system on host (the same host/device split as
models/dmd.py), costing
O(maxiter * (m r^2 + r^3)) — microseconds next to the projection. For
BOP-DMD the projection is shared across all members, so B bagged fits
add only B host solves on (m_sub, r) matrices.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.checkpoint import register_model_class
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["OptDmd", "BopDmd", "bop_dmd"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)

# exp(alpha t) overflows f64 near 709; reject such steps instead of
# letting inf/nan poison the LM linear algebra
_EXP_CLIP = 700.0


def _exp_mat(alpha, t):
    """A(alpha)[k, j] = exp(alpha_j t_k), (m, r) complex; None when the
    exponent overflows (caller treats it as an infeasible LM step)."""
    z = np.multiply.outer(t, alpha)            # (m, r)
    if np.max(z.real) > _EXP_CLIP:
        return None
    return np.exp(z)


def _residual(alpha, t, y):
    """Variable projection residual pieces at alpha.

    y: (m, r_y) projected-data target (rows = snapshots). Returns
    (rss, a, b, res) with b = A^+ y the eliminated linear params and
    res = y - A b, or (inf, None, None, None) when A overflows/fails.
    """
    a = _exp_mat(alpha, t)
    if a is None:
        return np.inf, None, None, None
    b, *_ = np.linalg.lstsq(a, y, rcond=None)
    res = y - a @ b
    rss = float(np.sum(np.abs(res) ** 2))
    if not np.isfinite(rss):
        return np.inf, None, None, None
    return rss, a, b, res


def _varpro_lm(alpha0, t, y, maxiter=60, tol=1e-9, lm0=1.0):
    """Complex Levenberg-Marquardt on the varpro objective
    ``min_alpha || y - A(alpha) A(alpha)^+ y ||_F^2``.

    Kaufman's Jacobian approximation (column j):
    ``J_j = -P_perp(A) (t * A[:, j]) b[j, :]`` — the standard optdmd
    iteration (Askham & Kutz 2018 eq. 3.3-3.5, Kaufman 1975). Complex
    normal equations ``(J^H J + lm * diag) d = -J^H vec(res)`` give the
    Gauss-Newton/LM step directly (Wirtinger calculus: the objective is
    real-analytic in (alpha, conj(alpha)) and J is the d/d alpha block;
    the conjugate block is J's conjugate acting on conj(d), which the
    normal equations already absorb).
    """
    alpha = np.asarray(alpha0, np.complex128).copy()
    r = alpha.size
    rss, a, b, res = _residual(alpha, t, y)
    if not np.isfinite(rss):
        raise ValueError(
            "optdmd: initial alpha overflows exp(alpha t); rescale t or "
            "pass a finite alpha0"
        )
    lm = float(lm0)
    for _ in range(int(maxiter)):
        # qr of A for the projector P_perp v = v - Q (Q^H v)
        q, _ = np.linalg.qr(a, mode="reduced")
        da = t[:, None] * a                      # (m, r): d A[:,j]/d a_j
        da_perp = da - q @ (q.conj().T @ da)
        # J columns stacked over the r_y residual columns:
        # J[:, j] = -vec(da_perp[:, j] outer b[j, :])
        # J^H J[i, j] = (da_perp_i^H da_perp_j) (b_i b_j^H)
        g = da_perp.conj().T @ da_perp           # (r, r)
        bbh = b @ b.conj().T                     # (r, r)
        jhj = g * bbh.conj()
        # jhr_i = J_i^H vec(res) = -da_perp_i^H (res b_i^H)
        jhr = -np.sum(np.conj(da_perp) * (res @ b.conj().T), axis=0)
        diag = np.maximum(np.abs(np.diag(jhj)), 1e-30)
        step_ok = False
        for _ in range(30):
            try:
                d = np.linalg.solve(jhj + lm * np.diag(diag), -jhr)
            except np.linalg.LinAlgError:
                lm *= 10.0
                continue
            rss_new, a_new, b_new, res_new = _residual(alpha + d, t, y)
            if rss_new < rss:
                step_ok = True
                break
            lm *= 10.0
        if not step_ok:
            break
        improve = (rss - rss_new) / max(rss, 1e-300)
        alpha = alpha + d
        rss, a, b, res = rss_new, a_new, b_new, res_new
        lm = max(lm / 10.0, 1e-12)
        if improve < tol:
            break
    return alpha, b, rss


def _project(x, n_modes, n_iters, n_os, key):
    """Device stage: rank-r POD basis + projected snapshots.
    Returns (u (n_x, r), xp (r, m)) as device arrays."""
    u, _, _ = random_svd(x, n_modes, n_iters, n_os, key=key)
    return u, _mm(u.T, x)


def _alpha_init(xp, t):
    """Exact-DMD warm start in the projected space: eig of
    X2p pinv(X1p), alpha = log(lambda) / median spacing. Host (r, m)."""
    dt = float(np.median(np.diff(t)))
    x1, x2 = xp[:, :-1], xp[:, 1:]
    a_op = x2 @ np.linalg.pinv(x1)
    lam = np.linalg.eigvals(a_op)
    lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam)
    return np.log(lam.astype(np.complex128)) / dt


def _alpha_init_hankel(x, t, r):
    """Warm start when the observable is rank-deficient (n_x < r, e.g.
    a scalar series fit with r exponentials): rank-r exact DMD on a
    time-delay embedding deep enough to expose r dynamic modes.
    Host numpy; tiny (the embedding is (n_x d, m - d + 1))."""
    n_x, m = x.shape
    d = int(np.ceil(r / n_x)) + 1
    if m - d < r + 1:
        raise ValueError(
            f"n_modes={r} exponentials need m >= {r + d + 1} snapshots "
            f"of a {n_x}-channel series for the delay-embedded warm "
            f"start, got m={m}"
        )
    cols = m - d + 1
    h = np.stack([x[:, j:j + cols] for j in range(d)]).reshape(
        d * n_x, cols
    )
    h1, h2 = h[:, :-1], h[:, 1:]
    u, s, vt = np.linalg.svd(h1, full_matrices=False)
    u, s, vt = u[:, :r], s[:r], vt[:r]
    a_til = u.T @ h2 @ vt.T / s[None, :]
    lam = np.linalg.eigvals(a_til)
    lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam)
    dt = float(np.median(np.diff(t)))
    return np.log(lam.astype(np.complex128)) / dt


def _finalize(u_np, b, dtype):
    """Lift projected loadings to state space and split into unit-norm
    complex modes + positive amplitudes: U B^T = Phi diag(amp)."""
    phi = u_np @ b.T                            # (n_x, r) complex
    amp = np.linalg.norm(phi, axis=0)
    amp_safe = np.where(amp > 0, amp, 1.0)
    phi = phi / amp_safe[None, :]
    return (jnp.asarray(np.ascontiguousarray(phi.real), dtype),
            jnp.asarray(np.ascontiguousarray(phi.imag), dtype), amp)


@register_model_class
class OptDmd:
    """Optimized (variable-projection) DMD fit of
    ``x(t) ~= Re(Phi diag(amplitudes) exp(alphas t))``.

    x_data: (n_x, m) snapshot columns — or (m,) for one channel;
    t: (m,) sample times (default ``arange(m) * dt``; arbitrary real
    spacing is fine — this is the solver to use on unequally sampled
    data); n_modes: model rank r — MAY exceed the channel count (a
    scalar series fit with r exponentials is Prony's problem; the warm
    start then comes from a delay-embedded exact DMD); alpha0:
    optional (r,) complex warm
    start (default: exact DMD on the projected data, which assumes the
    spacing is ROUGHLY uniform — pass alpha0 when it is not);
    maxiter/tol: LM budget; n_iters/n_oversamples/key: RSVD projection.

    Attributes: ``alphas`` (r,) complex continuous eigenvalues,
    ``modes_re``/``modes_im`` (n_x, r) unit-norm mode shapes,
    ``amplitudes`` (r,) positive reals, ``rss`` final residual.
    ``predict(times)`` evaluates the model at ANY real times —
    interpolation between snapshots and extrapolation both included.
    """

    def __init__(self, x_data, n_modes: int, t=None, dt: float = 1.0,
                 alpha0=None, maxiter: int = 60, tol: float = 1e-9,
                 n_iters: int = 10, key=0, n_oversamples: int = 8):
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        x = jnp.asarray(x_data)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] < 3:
            raise ValueError(
                f"x_data must be (n_x, m >= 3), got {np.shape(x_data)}"
            )
        (x,) = maybe_route_small(x)
        n_x, m = int(x.shape[0]), int(x.shape[1])
        r = int(n_modes)
        if not 1 <= r <= m - 1:
            raise ValueError(
                f"n_modes must be in [1, m-1] = [1, {m - 1}], "
                f"got {n_modes}"
            )
        if t is None:
            t = np.arange(m, dtype=np.float64) * float(dt)
        t = np.asarray(t, np.float64).reshape(-1)
        if t.size != m:
            raise ValueError(f"t must have m={m} entries, got {t.size}")
        if np.any(np.diff(t) <= 0):
            raise ValueError("t must be strictly increasing")

        if n_x >= r:
            # rank-r POD projection (the large-n_x work, on device);
            # varpro runs on the (m, r) projected target
            u, xp = _project(x, r, int(n_iters), int(n_oversamples),
                             as_key(key))
            y = np.asarray(xp, np.float64).T
            u_np = np.asarray(u, np.float64)
        else:
            # rank-deficient observables (n_x < r, e.g. one channel fit
            # with r exponentials): fit the raw channels directly —
            # varpro never needed n_x >= r, only the warm start does,
            # and _alpha_init_hankel supplies it via delay embedding
            u, u_np = None, None
            y = np.asarray(x, np.float64).T
        if alpha0 is None:
            alpha0 = (_alpha_init(y.T, t) if u is not None
                      else _alpha_init_hankel(np.asarray(x, np.float64),
                                              t, r))
        else:
            alpha0 = np.asarray(alpha0, np.complex128).reshape(-1)
            if alpha0.size != r:
                raise ValueError(
                    f"alpha0 must have r={r} entries, got {alpha0.size}"
                )
        alphas, b, rss = _varpro_lm(alpha0, t, y,
                                    maxiter=maxiter, tol=tol)
        self.n_state, self.n_modes = n_x, r
        self.alphas = alphas
        self.rss = float(rss)
        self.t_span = (float(t[0]), float(t[-1]))
        self.modes_re, self.modes_im, self.amplitudes = _finalize(
            u_np if u_np is not None else np.eye(n_x), b, x.dtype
        )

    def eigs_discrete(self, dt: float = 1.0) -> np.ndarray:
        """One-step eigenvalues exp(alphas * dt) (complex host array)."""
        return np.exp(self.alphas * float(dt))

    def predict(self, times) -> jnp.ndarray:
        """Evaluate the fitted model: (n_x, len(times)) real states at
        arbitrary times (device result; the (r, T) coefficient table is
        host complex, the (n_x, r)x(r, T) lift runs on device)."""
        tt = np.asarray(times, np.float64).reshape(-1)
        coef = np.exp(np.multiply.outer(self.alphas, tt))  # (r, T)
        coef = coef * np.asarray(self.amplitudes)[:, None]
        dt_ = self.modes_re.dtype
        c_re = jnp.asarray(np.ascontiguousarray(coef.real), dt_)
        c_im = jnp.asarray(np.ascontiguousarray(coef.imag), dt_)
        return _mm(self.modes_re, c_re) - _mm(self.modes_im, c_im)


@register_model_class
class BopDmd:
    """Result container for :func:`bop_dmd`.

    ``alphas_ref`` (r,) full-data optimized-DMD eigenvalues;
    ``alphas_all`` (B, r) member eigenvalues ALIGNED to the reference;
    ``alphas_mean``/``alphas_std`` the bagged point estimate and
    scatter; ``modes_re``/``modes_im`` (n_x, r) reference mode shapes;
    ``amps_all`` (B, r) member amplitudes. ``predict(times)`` is the
    bagged-mean forecast; ``predict_interval`` adds pointwise
    percentile bands (the BOP-DMD UQ product).
    """

    def predict(self, times) -> np.ndarray:
        mean, _, _ = self.predict_interval(times)
        return mean

    def predict_interval(self, times, lo: float = 2.5,
                         hi: float = 97.5):
        """(mean, lo_band, hi_band), each (n_x, T): statistics over the
        member spectral forecasts at the given times."""
        tt = np.asarray(times, np.float64).reshape(-1)
        phi_ref = (np.asarray(self.modes_re)
                   + 1j * np.asarray(self.modes_im))
        nb = self.alphas_all.shape[0]
        preds = np.empty((nb, phi_ref.shape[0], tt.size))
        for i in range(nb):
            coef = np.exp(np.multiply.outer(self.alphas_all[i], tt))
            coef = coef * self.amps_all[i][:, None]
            preds[i] = np.real((self.phis_all[i] @ coef))
        return (preds.mean(axis=0),
                np.percentile(preds, lo, axis=0),
                np.percentile(preds, hi, axis=0))


def bop_dmd(x_data, n_modes: int, t=None, dt: float = 1.0,
            n_members: int = 64, subset_frac: float = 0.8,
            maxiter: int = 40, n_iters: int = 10, key=0,
            n_oversamples: int = 8) -> BopDmd:
    """Bagging-optimized DMD (Sashidhar & Kutz 2022): B optimized-DMD
    fits on random time subsets, warm-started from the full-data fit.

    The POD projection (the only large-n_x work) is computed ONCE on
    device and shared; each member is a host varpro solve on its
    (m_sub, r) subset. Returns :class:`BopDmd` with aligned eigenvalue
    clouds and percentile forecast bands.
    """
    from scipy.optimize import linear_sum_assignment

    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    if not 0.0 < subset_frac <= 1.0:
        raise ValueError(
            f"subset_frac must be in (0, 1], got {subset_frac}"
        )
    if n_members < 2:
        raise ValueError(f"n_members must be >= 2, got {n_members}")
    x = jnp.asarray(x_data)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[1] < 4:
        raise ValueError(
            f"x_data must be (n_x, m >= 4), got {np.shape(x_data)}"
        )
    (x,) = maybe_route_small(x)
    n_x, m = int(x.shape[0]), int(x.shape[1])
    r = int(n_modes)
    if t is None:
        t = np.arange(m, dtype=np.float64) * float(dt)
    t = np.asarray(t, np.float64).reshape(-1)
    if t.size != m:
        raise ValueError(f"t must have m={m} entries, got {t.size}")
    if np.any(np.diff(t) <= 0):
        raise ValueError("t must be strictly increasing")

    u, xp = _project(x, r, int(n_iters), int(n_oversamples), as_key(key))
    u_np = np.asarray(u, np.float64)
    xp_np = np.asarray(xp, np.float64)

    # full-data reference fit (also the members' warm start)
    alpha_ref = _alpha_init(xp_np, t)
    alpha_ref, b_ref, _ = _varpro_lm(alpha_ref, t, xp_np.T,
                                     maxiter=maxiter)
    m_sub = max(int(round(subset_frac * m)), r + 2)
    m_sub = min(m_sub, m)

    from corrla_rs_tpu.ops.design import _seed_from_key

    rng = np.random.default_rng(_seed_from_key(key))
    alphas_all = np.empty((int(n_members), r), np.complex128)
    amps_all = np.empty((int(n_members), r))
    phis_all = np.empty((int(n_members), n_x, r), np.complex128)
    for i in range(int(n_members)):
        idx = np.sort(rng.choice(m, size=m_sub, replace=False))
        a_i, b_i, _ = _varpro_lm(alpha_ref, t[idx], xp_np[:, idx].T,
                                 maxiter=maxiter)
        phi_i = u_np @ b_i.T
        amp_i = np.linalg.norm(phi_i, axis=0)
        phi_i = phi_i / np.where(amp_i > 0, amp_i, 1.0)[None, :]
        # align onto the reference spectrum
        cost = np.abs(a_i[None, :] - alpha_ref[:, None])
        _, cols = linear_sum_assignment(cost)
        alphas_all[i] = a_i[cols]
        amps_all[i] = amp_i[cols]
        phis_all[i] = phi_i[:, cols]  # unit-norm; amps_all holds scale

    out = BopDmd.__new__(BopDmd)
    out.n_state, out.n_modes = n_x, r
    out.alphas_ref = alpha_ref
    phi_ref = u_np @ b_ref.T
    amp_ref = np.linalg.norm(phi_ref, axis=0)
    phi_ref = phi_ref / np.where(amp_ref > 0, amp_ref, 1.0)[None, :]
    out.modes_re = jnp.asarray(phi_ref.real.copy(), x.dtype)
    out.modes_im = jnp.asarray(phi_ref.imag.copy(), x.dtype)
    out.amplitudes = amp_ref
    out.alphas_all = alphas_all
    out.amps_all = amps_all
    out.phis_all = phis_all
    out.alphas_mean = alphas_all.mean(axis=0)
    out.alphas_std = np.sqrt(np.mean(
        np.abs(alphas_all - out.alphas_mean[None, :]) ** 2, axis=0
    ))
    return out
