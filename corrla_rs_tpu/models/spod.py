"""Spectral POD (SPOD) — EXTENSION (no reference analogue).

The reference's POD (pod_rom.rs) diagonalizes the space-only covariance,
mixing all timescales into each mode. SPOD (Lumley's space-time POD in
the frequency domain; Towne, Schmidt & Colonius 2018) diagonalizes the
cross-spectral density at EACH frequency, giving modes that are
orthogonal at every frequency, optimally energy-ranked there, and —
unlike DMD modes — statistically converged for stationary turbulent
data (it is exactly the frequency-domain Karhunen-Loeve expansion).

Accelerator shape (complex algebra kept as real pairs, the DFT as dense
matmuls):
- Welch segmentation is ONE gather: (n_blocks, n_x, n_fft).
- The windowed real DFT is TWO real matmuls against precomputed
  cos/sin bases, (B n_x, n_fft) x (n_fft, n_freq) — pure matmul work,
  no complex arithmetic anywhere on device.
- Per-frequency SPOD uses the method of snapshots: the B x B Hermitian
  cross-spectral Grams M = Q^H Q split into real/imag parts by matmuls
  on device; their eigendecomposition is ONE batched host complex eigh
  over all frequencies (rank^2-sized work — and a direct complex eigh
  has no eigenvector-pairing ambiguity, unlike a real 2B x 2B
  embedding, whose degenerate clusters can yield complex-PARALLEL
  vector pairs).
- Mode lift Phi_f = Q_f V_f Lambda_f^{-1/2} is a batched device
  einsum; zero-energy directions (rank-deficient Grams, n_x < B) get
  exactly-zero mode columns instead of amplified roundoff.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["Spod", "spod"]

_mm = functools.partial(jnp.matmul, precision=PRECISION)


@functools.partial(jax.jit, static_argnames=("n_fft", "hop", "n_blocks"))
def _spod_dft_kernel(x, window, n_fft, hop, n_blocks):
    """Device stage 1: Welch blocks + windowed real DFT + per-frequency
    cross-spectral Grams. Returns (q_re, q_im) (n_freq, n_x, B) and
    (m_re, m_im) (n_freq, B, B). All-real algebra; see module doc."""
    n_x = x.shape[0]
    dtype = x.dtype
    # Welch blocks: one gather -> (B, n_x, n_fft), windowed
    idx = (jnp.arange(n_blocks)[:, None] * hop
           + jnp.arange(n_fft)[None, :])              # (B, n_fft)
    blocks = x[:, idx] * window[None, None, :]        # (n_x, B, n_fft)
    blocks = jnp.transpose(blocks, (1, 0, 2))         # (B, n_x, n_fft)
    # real DFT as two matmuls (rfft bins 0..n_fft//2)
    n_freq = n_fft // 2 + 1
    k = jnp.arange(n_fft, dtype=dtype)[:, None]
    f = jnp.arange(n_freq, dtype=dtype)[None, :]
    ang = 2.0 * jnp.pi * k * f / n_fft
    flat = blocks.reshape(n_blocks * n_x, n_fft)
    q_re = _mm(flat, jnp.cos(ang)).reshape(n_blocks, n_x, n_freq)
    q_im = _mm(flat, -jnp.sin(ang)).reshape(n_blocks, n_x, n_freq)
    # frequency-major realizations: (n_freq, n_x, B)
    q_re = jnp.transpose(q_re, (2, 1, 0))
    q_im = jnp.transpose(q_im, (2, 1, 0))

    def gram(qr, qi):
        m_re = (_mm(qr.T, qr) + _mm(qi.T, qi)) / n_blocks
        m_im = (_mm(qr.T, qi) - _mm(qi.T, qr)) / n_blocks
        return m_re, m_im

    m_re, m_im = jax.vmap(gram)(q_re, q_im)
    return q_re, q_im, m_re, m_im


@jax.jit
def _spod_lift_kernel(q_re, q_im, v_re, v_im, scale):
    """Device stage 2: Phi = Q V scale, batched over frequencies
    (complex split into re/im real matmuls)."""
    p_re = (jnp.einsum("fxb,fbk->fxk", q_re, v_re,
                       precision=PRECISION)
            - jnp.einsum("fxb,fbk->fxk", q_im, v_im,
                         precision=PRECISION))
    p_im = (jnp.einsum("fxb,fbk->fxk", q_re, v_im,
                       precision=PRECISION)
            + jnp.einsum("fxb,fbk->fxk", q_im, v_re,
                         precision=PRECISION))
    return p_re * scale[:, None, :], p_im * scale[:, None, :]


@register_model_class
class Spod:
    """Fitted SPOD (see :func:`spod`).

    ``freqs`` (n_freq,) — rfft frequencies in cycles / time unit;
    ``energies`` (n_freq, n_save) — modal energy spectra (lambda_j(f),
    descending in j; lambda_1(f) is THE spectrum to plot);
    ``modes_re``/``modes_im`` (n_freq, n_x, n_save) — SPOD modes,
    orthonormal within each frequency: Phi_f^H Phi_f = I.
    """

    @property
    def n_freq(self) -> int:
        return int(self.energies.shape[0])

    def mode(self, i_freq: int, j: int = 0):
        """(re, im) spatial shape of mode j at frequency bin i_freq."""
        return (self.modes_re[i_freq, :, j],
                self.modes_im[i_freq, :, j])

    def energy_interval(self, confidence: float = 0.95):
        """(lo, hi) multiplicative confidence bounds on ``energies``.

        Each SPOD eigenvalue is a mean over ``n_blocks`` (approximately
        independent) Welch realizations, so lambda_hat / lambda follows
        chi2(2 n_blocks) / (2 n_blocks) (Schmidt & Colonius, AIAA J.
        2020 sec. IV); the returned arrays are energies * factor."""
        from scipy.stats import chi2

        if not 0.0 < confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {confidence}"
            )
        a = 1.0 - float(confidence)
        dof = 2 * self.n_blocks
        lo = dof / chi2.ppf(1.0 - a / 2.0, dof)
        hi = dof / chi2.ppf(a / 2.0, dof)
        e = np.asarray(self.energies)
        return e * lo, e * hi

    def peak_frequencies(self, n_peaks: int = 1) -> np.ndarray:
        """Frequencies of the n_peaks largest leading-mode energies
        (excludes the DC bin)."""
        lead = np.asarray(self.energies[:, 0]).copy()
        lead[0] = -np.inf
        order = np.argsort(lead)[::-1][: int(n_peaks)]
        return np.asarray(self.freqs)[np.sort(order)]


def spod(x_data, n_fft: int = 128, overlap: float = 0.5,
         dt: float = 1.0, window: str = "hann",
         n_modes: int | None = None, weights=None, mesh=None) -> Spod:
    """Spectral POD of snapshot columns x_data (n_x, n_t).

    n_fft: Welch block length (frequency resolution 1/(n_fft dt));
    overlap: fractional block overlap in [0, 1); dt: sample spacing;
    window: 'hann' or 'boxcar'; n_modes: modes kept per frequency
    (default: all n_blocks); weights: optional (n_x,) positive spatial
    quadrature weights W (non-uniform grids / cell volumes — the
    Schmidt-Colonius practice): modes come back W-orthonormal
    (Phi^H diag(W) Phi = I) and energies integrate with W; mesh:
    optional 1-D jax.sharding.Mesh —
    rows of x shard across devices (blocks/DFT/mode-lift stay
    device-local; only the B x B cross-spectral Grams reduce over the
    row axis, which GSPMD lowers to one psum per part), so spatial
    grids larger than one chip's HBM decompose unchanged.

    Follows Towne-Schmidt-Colonius 2018 (alg. in sec. 3): mean removal,
    windowed Welch blocks, per-frequency method-of-snapshots
    eigendecomposition. Energies are scaled like the one-sided Welch
    PSD (window power normalization, x2 on interior bins) so
    sum_f sum_j lambda_j(f) * (1/(n_fft dt)) ~= var(x) for stationary
    data.
    """
    x = jnp.asarray(x_data)
    if x.ndim != 2:
        raise ValueError(f"x_data must be 2-d, got {x.ndim}-d")
    n_x, n_t = int(x.shape[0]), int(x.shape[1])
    n_fft = int(n_fft)
    if not 4 <= n_fft <= n_t:
        raise ValueError(
            f"n_fft must be in [4, n_t={n_t}], got {n_fft}"
        )
    if not 0.0 <= float(overlap) < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    hop = max(1, int(round(n_fft * (1.0 - float(overlap)))))
    n_blocks = (n_t - n_fft) // hop + 1
    if n_blocks < 2:
        raise ValueError(
            f"need >= 2 Welch blocks (n_t={n_t}, n_fft={n_fft}, "
            f"hop={hop} gives {n_blocks}); shorten n_fft or raise overlap"
        )
    if window == "hann":
        w_np = 0.5 - 0.5 * np.cos(
            2.0 * np.pi * np.arange(n_fft) / n_fft
        )
    elif window == "boxcar":
        w_np = np.ones(n_fft)
    else:
        raise ValueError(
            f"window must be 'hann' or 'boxcar', got {window!r}"
        )
    # one-sided Welch scaling: per-block DFTs x sqrt(2 dt / (n_fft W))
    # (W = mean squared window) => lambda has PSD units; DC/Nyquist
    # keep the one-sided doubling off
    w_pow = float(np.sum(w_np ** 2))
    # weighted inner product: run the whole pipeline on sqrt(W) x —
    # the CSD/eigvals are then W-weighted — and unweight the lifted
    # modes at the end so they are W-orthonormal in physical units
    sqrt_w = None
    if weights is not None:
        w_arr = np.asarray(weights, np.float64).reshape(-1)
        if w_arr.shape[0] != n_x or np.any(w_arr <= 0):
            raise ValueError(
                f"weights must be (n_x={n_x},) positive, got "
                f"shape {w_arr.shape}"
            )
        sqrt_w = np.sqrt(w_arr)
        x = x * jnp.asarray(sqrt_w, x.dtype)[:, None]
    if mesh is not None:
        from corrla_rs_tpu.parallel.mesh import shard_rows

        x = shard_rows(x, mesh)
    x = x - jnp.mean(x, axis=1, keepdims=True)
    win = jnp.asarray(w_np * np.sqrt(2.0 * float(dt) / w_pow), x.dtype)

    q_re, q_im, m_re, m_im = _spod_dft_kernel(x, win, n_fft, hop,
                                              n_blocks)
    # host complex Hermitian eigendecomposition of the tiny (B, B)
    # cross-spectral Grams, batched over frequencies: a direct complex
    # eigh has no eigenvector-pairing ambiguity (a real-embedding eigh
    # can return complex-PARALLEL vector pairs inside degenerate
    # clusters) and the matrices are rank^2-sized host work
    mm_c = np.asarray(m_re, np.float64) + 1j * np.asarray(m_im,
                                                          np.float64)
    w_all, v_all = np.linalg.eigh(mm_c)            # ascending
    w_all = np.maximum(w_all[:, ::-1], 0.0)        # descending, >= 0
    v_all = v_all[:, :, ::-1]
    keep = n_blocks if n_modes is None else min(int(n_modes), n_blocks)
    w_all, v_all = w_all[:, :keep], v_all[:, :, :keep]
    # relative floor: directions below eps * lambda_max(f) carry no
    # energy — zero their modes instead of amplifying roundoff junk
    # (an absolute floor produced ~1e134-scaled garbage columns on
    # rank-deficient Grams, n_x < n_blocks)
    tiny = np.finfo(np.float64).eps * np.maximum(
        w_all[:, :1], np.finfo(np.float64).tiny
    )
    good = w_all > tiny
    scale = np.where(good, 1.0 / np.sqrt(
        np.maximum(w_all, tiny) * n_blocks
    ), 0.0)
    dt_ = x.dtype
    p_re, p_im = _spod_lift_kernel(
        q_re, q_im,
        jnp.asarray(np.ascontiguousarray(v_all.real), dt_),
        jnp.asarray(np.ascontiguousarray(v_all.imag), dt_),
        jnp.asarray(scale, dt_),
    )
    if sqrt_w is not None:
        # back to physical units: modes W-orthonormal, not 2-orthonormal
        inv = jnp.asarray(1.0 / sqrt_w, dt_)[None, :, None]
        p_re = p_re * inv
        p_im = p_im * inv
    # undo the one-sided doubling at DC (and Nyquist for even n_fft)
    fix = np.ones(n_fft // 2 + 1)
    fix[0] = 0.5
    if n_fft % 2 == 0:
        fix[-1] = 0.5
    energies = jnp.asarray(w_all * fix[:, None], dt_)
    out = Spod.__new__(Spod)
    out.n_state = n_x
    out.n_blocks = n_blocks
    out.n_fft = n_fft
    out.freqs = np.fft.rfftfreq(n_fft, d=float(dt))
    out.energies = energies
    out.modes_re = p_re
    out.modes_im = p_im
    return out
