"""Bagged DMD: eigenvalue/mode uncertainty via ensemble resampling —
EXTENSION (the BOP-DMD bagging idea, Sashidhar & Kutz 2022).

The reference's DMD-family fits (dmd_rom.rs) are point estimates: one
spectrum, no error bars — yet on noisy data DMD eigenvalues are biased
and mode shapes wobble. Bagging fits B exact-DMD models on random
snapshot-pair subsets and reads the spread: eigenvalue scatter, mode
bands, and forecast intervals.

Accelerator shape: all B subset fits run as ONE jit+vmap dispatch (the
same trick as models/dmd.dmdc_fit_ensemble, enabled by the on-device
Francis-QR eigensolver): per member — subset gather, randomized SVD of
X1_sub, reduced operator, eig_device, exact modes — all real algebra
(complex handled as re/im pairs). Only the O(B r^2) eigenvalue
alignment (optimal assignment against the full-data reference spectrum)
and the band statistics run on host.

Note bagging subsets PAIRS, not contiguous windows: exact DMD is a
regression on snapshot pairs, so pair subsampling is the exchangeable
unit (the original BOP-DMD subsamples time points of a trajectory for
its variable-projection solver; for the pair-regression formulation the
pair is the sample).
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

__all__ = ["BaggedDmd", "bagged_dmd"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.lru_cache(maxsize=32)
def _bagged_fitter(n_pairs, n_sub, n_modes, n_iters, n_os):
    """Cached jit(vmap) over members: subset -> RSVD -> reduced op ->
    device eig -> exact modes. Static shapes per configuration."""
    from corrla_rs_tpu.ops.eig_device import eig_device

    def fit_one(x1, x2, key):
        k_sub, k_svd = jax.random.split(key)
        idx = jax.random.choice(
            k_sub, n_pairs, shape=(n_sub,), replace=False
        )
        x1s = jnp.take(x1, idx, axis=1)
        x2s = jnp.take(x2, idx, axis=1)
        u, s, vt = random_svd(x1s, n_modes, n_iters, n_os, key=k_svd)
        s_inv = jnp.where(
            s > jnp.finfo(s.dtype).eps * s[0], 1.0 / s, 0.0
        )
        # A~ = U^T X2 V S^-1 ; exact modes Phi = X2 V S^-1 W
        x2vs = _mm(x2s, vt.T * s_inv[None, :])          # (n, r)
        a_til = _mm(u.T, x2vs)                          # (r, r)
        lam_re, lam_im, w_re, w_im = eig_device(a_til)
        modes_re = _mm(x2vs, w_re)
        modes_im = _mm(x2vs, w_im)
        return lam_re, lam_im, modes_re, modes_im

    return jax.jit(jax.vmap(fit_one, in_axes=(None, None, 0)))


def _align(lam_ref, lam_mem):
    """Optimal assignment of one member's eigenvalues onto the
    reference spectrum (min total complex distance)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(lam_mem[None, :] - lam_ref[:, None])
    _, cols = linear_sum_assignment(cost)
    return cols


@register_model_class
class BaggedDmd:
    """Result container for :func:`bagged_dmd` (attribute bag so it
    checkpoints through utils/checkpoint like every other model).

    ``lambdas_ref`` (r,) full-data reference spectrum;
    ``lambdas_all`` (B, r) member spectra ALIGNED to the reference;
    ``lambdas_mean`` / ``lambdas_std`` (r,) bagged point estimate and
    complex scatter (std of the aligned cloud, sqrt of mean squared
    distance from its mean);
    ``modes_ref`` / ``modes_mean`` / ``modes_std`` (n, r) — member
    modes are least-squares rescaled onto the reference mode before
    the statistics (DMD mode scale/phase is arbitrary per fit).
    """

    def predict(self, x_0, n_steps: int) -> np.ndarray:
        """Bagged-mean spectral forecast (n, n_steps): the mean over
        members of x_t^b = Re(Phi_b (lam_b^t * b0_b))."""
        mean, _, _ = self.predict_interval(x_0, n_steps)
        return mean

    def predict_interval(self, x_0, n_steps: int, lo: float = 2.5,
                         hi: float = 97.5):
        """(mean, lo_band, hi_band) each (n, n_steps): pointwise
        percentiles of the member spectral forecasts — the bagged
        forecast-uncertainty band."""
        x0 = np.asarray(x_0, np.float64).reshape(-1)
        if x0.size != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.size}"
            )
        t = np.arange(1, int(n_steps) + 1)
        preds = np.empty(
            (self.n_members, self.n_state, t.size), np.float64
        )
        for b in range(self.n_members):
            phi = self.modes_all_re[b] + 1j * self.modes_all_im[b]
            lam = self.lambdas_all[b]
            b0, _, _, _ = np.linalg.lstsq(phi, x0, rcond=None)
            coefs = (lam[None, :] ** t[:, None]) * b0[None, :]  # (T, r)
            preds[b] = np.real(coefs @ phi.T).T
        return (
            preds.mean(axis=0),
            np.percentile(preds, lo, axis=0),
            np.percentile(preds, hi, axis=0),
        )


def bagged_dmd(x_data, n_modes: int, n_members: int = 64,
               subset_frac: float = 0.8, n_iters: int = 10, key=0,
               n_oversamples: int = 8) -> BaggedDmd:
    """Fit B exact-DMD models on random snapshot-pair subsets.

    x_data: (n, m) trajectory columns (m-1 pairs). ``subset_frac`` of
    the pairs (without replacement) go into each member. All members
    fit in one batched device dispatch; see :class:`BaggedDmd` for the
    returned statistics.
    """
    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    if not 0.0 < subset_frac <= 1.0:
        raise ValueError(
            f"subset_frac must be in (0, 1], got {subset_frac}"
        )
    if n_members < 2:
        raise ValueError(f"n_members must be >= 2, got {n_members}")
    (x_data,) = maybe_route_small(x_data)
    x = jnp.asarray(x_data)
    if x.ndim != 2 or x.shape[1] < 3:
        raise ValueError(
            f"x_data must be (n, m >= 3), got {np.shape(x_data)}"
        )
    n, m = x.shape
    n_pairs = m - 1
    n_sub = max(int(round(subset_frac * n_pairs)), int(n_modes) + 1)
    n_sub = min(n_sub, n_pairs)
    x1, x2 = x[:, :-1], x[:, 1:]

    keys = jax.random.split(as_key(key), int(n_members) + 1)
    fitter = _bagged_fitter(
        n_pairs, n_sub, int(n_modes), int(n_iters), int(n_oversamples)
    )
    lam_re, lam_im, mo_re, mo_im = fitter(x1, x2, keys[1:])
    lam_all = np.asarray(lam_re) + 1j * np.asarray(lam_im)
    mo_re, mo_im = np.asarray(mo_re), np.asarray(mo_im)

    # full-data reference fit for alignment
    from corrla_rs_tpu.models.dmd import DMD

    ref = DMD(x, int(n_modes), n_iters=int(n_iters), key=keys[0])
    lam_ref = ref.lambdas
    phi_ref = np.asarray(ref.modes_re) + 1j * np.asarray(ref.modes_im)

    r = int(n_modes)
    out = BaggedDmd.__new__(BaggedDmd)
    out.n_state = int(n)
    out.n_members = int(n_members)
    out.n_modes = r
    out.lambdas_ref = lam_ref
    out.modes_ref_re = jnp.asarray(np.real(phi_ref))
    out.modes_ref_im = jnp.asarray(np.imag(phi_ref))
    aligned_lam = np.empty_like(lam_all)
    aligned_re = np.empty_like(mo_re)
    aligned_im = np.empty_like(mo_im)
    for b in range(int(n_members)):
        cols = _align(lam_ref, lam_all[b])
        aligned_lam[b] = lam_all[b][cols]
        phi_b = (mo_re[b] + 1j * mo_im[b])[:, cols]
        # least-squares complex rescale of each mode onto the reference
        # (per-fit mode scale/phase is arbitrary)
        denom = np.sum(np.abs(phi_b) ** 2, axis=0)
        denom = np.where(denom > 0, denom, 1.0)
        c = np.sum(np.conj(phi_b) * phi_ref, axis=0) / denom
        phi_b = phi_b * c[None, :]
        aligned_re[b] = np.real(phi_b)
        aligned_im[b] = np.imag(phi_b)
    out.lambdas_all = aligned_lam
    out.modes_all_re = aligned_re
    out.modes_all_im = aligned_im
    out.lambdas_mean = aligned_lam.mean(axis=0)
    out.lambdas_std = np.sqrt(
        np.mean(np.abs(aligned_lam - out.lambdas_mean[None, :]) ** 2,
                axis=0)
    )
    phi_all = aligned_re + 1j * aligned_im
    out.modes_mean = phi_all.mean(axis=0)
    out.modes_std = np.sqrt(
        np.mean(np.abs(phi_all - out.modes_mean[None]) ** 2, axis=0)
    )
    return out
