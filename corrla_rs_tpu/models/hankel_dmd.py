"""Hankel (time-delay) DMD — EXTENSION (no reference analogue).

The reference's ROM layer (dmd_rom.rs) regresses snapshot-to-snapshot
maps on the RAW state. That fails whenever the observable stream is
rank-deficient relative to the dynamics: a scalar sensor, a standing
wave (spatial rank 1, dynamic rank 2), or any system measured through
too few channels. Time-delay embedding fixes it: stack d consecutive
snapshots into one column (a block-Hankel matrix) and the embedded
system IS linear of full dynamic rank (Takens; the HAVOK/Hankel-DMD
view of Brunton et al. 2017, Arbabi & Mezic 2017).

Accelerator shape: the Hankel matrix is ONE gather (x[:, idx] with a
(d, m_h) index grid) + transpose/reshape — no Python loop over delays —
and everything downstream reuses the exact-DMD machinery (randomized
SVD as dense matmuls, host or Francis-QR device eig, lax.scan rollouts).
``HankelDmd`` subclasses :class:`~corrla_rs_tpu.models.dmd.DMD`, so
solver='tls'/'fb' noise debiasing and eig_backend='device' compose
with the embedding for free.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from corrla_rs_tpu.models.dmd import DMD
from corrla_rs_tpu.utils.checkpoint import register_model_class
from corrla_rs_tpu.utils.config import DmdConfig

__all__ = ["HankelDmd", "hankel_embed"]


@functools.partial(jax.jit, static_argnames=("n_delays",))
def hankel_embed(x_data, n_delays: int):
    """Block-Hankel time-delay embedding of snapshot columns.

    x_data: (n_x, n_t). Returns (n_x * n_delays, n_t - n_delays + 1)
    whose column j stacks x[:, j], x[:, j+1], ..., x[:, j+d-1] — the
    NEWEST snapshot is the bottom block. One gather, no loops.
    """
    n_x, n_t = x_data.shape
    m_h = n_t - n_delays + 1
    # shapes are static, so these raise at trace time (not silently
    # returning an (n_x d, 0) matrix for oversized depths)
    if n_delays < 1:
        raise ValueError(f"n_delays must be >= 1, got {n_delays}")
    if m_h < 1:
        raise ValueError(
            f"n_delays={n_delays} leaves no embedded columns "
            f"(n_t={n_t})"
        )
    idx = jnp.arange(m_h)[None, :] + jnp.arange(n_delays)[:, None]
    h = x_data[:, idx]                       # (n_x, d, m_h)
    return jnp.transpose(h, (1, 0, 2)).reshape(n_delays * n_x, m_h)


@register_model_class
class HankelDmd(DMD):
    """Exact DMD on a time-delay (block-Hankel) embedding.

    x_data: (n_x, n_t) snapshots; n_delays: embedding depth d (the
    embedded state dimension is n_x * d, so the fit can resolve up to
    n_x * d dynamic modes from as little as ONE sensor channel);
    n_modes / n_iters / key / eig_backend / solver / config: forwarded
    to :class:`DMD` on the embedded matrix.

    After fit, ``lambdas`` / ``eigs_continuous(dt)`` are the spectrum
    of the UNDERLYING dynamics (delay embedding preserves it), and
    ``modes_re``/``modes_im`` live in the embedded space —
    ``state_modes()`` returns their newest-time block, the mode shapes
    on the raw state. ``forecast(n)`` continues the training series;
    ``forecast(n, x_hist=...)`` continues any d-deep history.
    """

    def __init__(self, x_data, n_delays: int, n_modes: int,
                 n_iters: int = 10, key=0, eig_backend: str = "host",
                 solver: str = "exact", config: DmdConfig | None = None):
        x = jnp.asarray(x_data)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"x_data must be 1-d or 2-d, got {x.ndim}-d")
        d = int(n_delays)
        if d < 1:
            raise ValueError(f"n_delays must be >= 1, got {n_delays}")
        if x.shape[1] - d + 1 < 2:
            raise ValueError(
                f"need n_t - n_delays + 1 >= 2 embedded columns, got "
                f"n_t={x.shape[1]}, n_delays={d}"
            )
        self.n_delays = d
        self.n_state = int(x.shape[0])
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        # route on the EMBEDDED work size (d x the raw input), before the
        # gather, so the whole fit stays on one backend (DMD's own routing
        # of h is then a no-op: committed arrays are never re-routed)
        (x,) = maybe_route_small(x, work_elems=int(x.size) * d)
        h = hankel_embed(x, d)
        self._h_last = h[:, -1:]
        super().__init__(h, n_modes, n_iters=n_iters, key=key,
                         eig_backend=eig_backend, solver=solver,
                         config=config)

    def state_modes(self):
        """(n_x, r) real/imag mode shapes on the RAW state — the
        newest-time block of the embedded modes."""
        return (self.modes_re[-self.n_state:, :],
                self.modes_im[-self.n_state:, :])

    def _embed_tail(self, x_hist) -> jnp.ndarray:
        xh = jnp.asarray(x_hist)
        if xh.ndim == 1:
            xh = xh[None, :]
        if xh.shape[0] != self.n_state or xh.shape[1] < self.n_delays:
            raise ValueError(
                f"x_hist must be ({self.n_state}, >= {self.n_delays}), "
                f"got {xh.shape}"
            )
        # (n_x, d) tail -> (d, n_x) -> flat: delay-major like hankel_embed
        return xh[:, -self.n_delays:].T.reshape(-1, 1)

    def forecast(self, n_steps: int, x_hist=None,
                 method: str = "modes") -> jnp.ndarray:
        """Roll the embedded system ``n_steps`` forward and read off the
        newest-time block: (n_x, n_steps) future raw states.

        x_hist: optional (n_x, >= n_delays) history whose last d columns
        seed the embedded state (default: the end of the training data).
        method: 'modes' (factored spectral rollout) or 'reduced' (no
        host eig in the chain), as in :meth:`DMD.predict_multiple`.
        """
        h0 = self._h_last if x_hist is None else self._embed_tail(x_hist)
        hs = self.predict_multiple(h0, int(n_steps), method=method)
        return hs[-self.n_state:, :]
