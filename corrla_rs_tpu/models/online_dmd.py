"""Online DMD / DMDc: streaming least-squares operator updates — EXTENSION.

The reference's DMDc refits from scratch on the full snapshot matrices
(dmd_rom.rs:45-109, a batch algorithm); a controller or monitor watching
a live system wants the operator updated per time step. This module
implements the exponentially-weighted recursive least-squares ("online
DMD", Zhang, Rowley, Deem & Cattafesta 2019) estimate of the full
operator [A B] from streaming snapshot pairs:

    minimize_{[A B]}  sum_i rho^{k-i} || y_i - A x_i - B u_i ||^2
                      (+ ridge * rho^k * ||[A B]||_F^2)

maintaining the solution under appends in O((n+q)^2 c) per batch of c
pairs via the Woodbury identity — independent of how many pairs have
ever been absorbed. With ``forgetting=1`` the estimate equals the
ridge-regularized batch solution Y Z^T (Z Z^T + ridge I)^{-1} exactly
(fp-level); with ``forgetting<1`` old data decays exponentially and the
estimate tracks time-varying dynamics (the ridge decays with it, as in
standard RLS).

State is ([A B] (n, n+q), P (n+q, n+q)) where P is the inverse weighted
Gram; memory is O((n+q)^2), so this targets moderate state dimensions
(n + q up to a few thousand — above that, project first: fit a POD/PCA
basis and stream the reduced coordinates).

Accelerator notes: one batch update is ONE jitted kernel — two (n+q, c)
dense matmuls plus a (c, c) LU solve; static shapes per (n, q, c),
so a fixed streaming batch size reuses one compiled executable and the
state never leaves the device. Sub-threshold problems are committed to
the in-process CPU backend at construction (utils/smallpath): per-step
online updates of a small system are the textbook dispatch-bound
workload (a kernel launch per update vs ~us of FLOPs).
Eigenvalues of the estimated A use the host eigensolver
(ops/eig.eig_host) like models/dmd.py — the matrix is n x n
nonsymmetric.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.eig import eig_host
from corrla_rs_tpu.ops.mat_utils import PRECISION

__all__ = ["OnlineDmd"]


@jax.jit
def _rls_update(ab, p, z, y, rho):
    """One exponentially-weighted RLS batch update.

    ab: (n, p_dim) current operator [A B]; p: (p_dim, p_dim) inverse
    weighted Gram; z: (p_dim, c) regressors [x; u]; y: (n, c) targets.
    Returns (ab', p').

    Forgetting is per snapshot PAIR, not per call: absorbing a c-column
    batch decays all past data by rho^c and weights column i of the
    batch by rho^(c-1-i) (the last column is the newest). Weighted LS
    folds the weights in as column scalings by sqrt(w); then with
    P~ = P/rho^c and Gamma = (I_c + Z~^T P~ Z~)^{-1},
        [A B]' = [A B] + (Y~ - [A B] Z~) Gamma Z~^T P~
        P'     = P~ - P~ Z~ Gamma Z~^T P~        (Woodbury, exact).
    """
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    c = z.shape[1]
    w_sqrt = rho ** (0.5 * jnp.arange(c - 1, -1, -1, dtype=z.dtype))
    z = z * w_sqrt[None, :]
    y = y * w_sqrt[None, :]
    p_t = p / rho ** c
    pz = mm(p_t, z)                                        # (p_dim, c)
    core = jnp.eye(c, dtype=z.dtype) + mm(z.T, pz)         # (c, c)
    # g = Gamma Z^T P~ ; P~ is symmetric so Z^T P~ = pz.T
    g = jnp.linalg.solve(core, pz.T)                       # (c, p_dim)
    err = y - mm(ab, z)
    ab_new = ab + mm(err, g)
    p_new = p_t - mm(pz, g)
    p_new = 0.5 * (p_new + p_new.T)                        # kill drift
    return ab_new, p_new


@jax.jit
def _rollout_ab(a_op, b_op, x0, u_seq):
    """x_{k+1} = A x_k + B u_k over u_seq columns via lax.scan."""
    mm = functools.partial(jnp.matmul, precision=PRECISION)

    def step(x, u_col):
        x_next = mm(a_op, x) + mm(b_op, u_col[:, None])
        return x_next, x_next[:, 0]

    _, xs = lax.scan(step, x0, u_seq.T)
    return xs.T


@jax.jit
def _rollout_a(a_op, x0, n_steps_ones):
    mm = functools.partial(jnp.matmul, precision=PRECISION)

    def step(x, _):
        x_next = mm(a_op, x)
        return x_next, x_next[:, 0]

    _, xs = lax.scan(step, x0, n_steps_ones)
    return xs.T


class OnlineDmd:
    """Streaming DMD/DMDc operator estimate under snapshot-pair appends.

    Layout matches models/dmd.DMDc (columns are snapshots): ``update(x,
    y, u)`` absorbs c pairs where ``x`` (n, c) are current states, ``y``
    (n, c) the successor states, ``u`` (q, c) the applied controls
    (required iff n_ctrl > 0). 1-D inputs are treated as single pairs.

    Parameters
    ----------
    n_state : state dimension n.
    n_ctrl : control dimension q (0 = plain online DMD).
    forgetting : rho in (0, 1]; 1 = all data weighted equally (exact
        batch ridge solution), <1 = exponential decay with time constant
        ~1/(1-rho) snapshot pairs for tracking time-varying dynamics.
    ridge : initial Tikhonov weight lambda (P_0 = I/lambda). The default
        1e-8 makes the estimate match the unregularized least-squares
        solution to ~fp precision once the Gram is well-conditioned.
    dtype : state dtype (default f64 under x64, else f32).
    """

    def __init__(self, n_state: int, n_ctrl: int = 0,
                 forgetting: float = 1.0, ridge: float = 1.0e-8,
                 dtype=None):
        if n_state < 1:
            raise ValueError(f"n_state must be >= 1, got {n_state}")
        if n_ctrl < 0:
            raise ValueError(f"n_ctrl must be >= 0, got {n_ctrl}")
        if not 0.0 < forgetting <= 1.0:
            raise ValueError(
                f"forgetting must be in (0, 1], got {forgetting}"
            )
        if ridge <= 0.0:
            raise ValueError(f"ridge must be > 0, got {ridge}")
        self.n_state = int(n_state)
        self.n_ctrl = int(n_ctrl)
        self.forgetting = float(forgetting)
        self.ridge = float(ridge)
        p_dim = self.n_state + self.n_ctrl
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 \
                else jnp.float32
        ab = jnp.zeros((self.n_state, p_dim), dtype)
        p = jnp.eye(p_dim, dtype=dtype) / self.ridge
        # per-step online updates of a small system are dispatch-bound
        # on an accelerator; commit sub-threshold state to the
        # in-process CPU backend once — updates follow the placement
        from corrla_rs_tpu.utils.smallpath import maybe_route_small
        self._ab, self._p = maybe_route_small(
            ab, p, work_elems=p_dim * p_dim + self.n_state * p_dim,
        )
        self.n_seen = 0

    # -- streaming -------------------------------------------------------
    def _coerce(self, arr, rows, name):
        a = jnp.asarray(arr, dtype=self._ab.dtype)
        if a.ndim == 1:
            a = a[:, None]
        if a.ndim != 2 or a.shape[0] != rows:
            raise ValueError(
                f"{name} must be ({rows}, c), got {np.shape(arr)}"
            )
        return a

    def update(self, x, y, u=None) -> "OnlineDmd":
        """Absorb snapshot pairs: columns x_i -> y_i (under control u_i)."""
        x = self._coerce(x, self.n_state, "x")
        y = self._coerce(y, self.n_state, "y")
        if y.shape[1] != x.shape[1]:
            raise ValueError(
                f"x has {x.shape[1]} columns, y has {y.shape[1]}"
            )
        if self.n_ctrl > 0:
            if u is None:
                raise ValueError("n_ctrl > 0 requires control columns u")
            u = self._coerce(u, self.n_ctrl, "u")
            if u.shape[1] != x.shape[1]:
                raise ValueError(
                    f"x has {x.shape[1]} columns, u has {u.shape[1]}"
                )
            z = jnp.concatenate([x, u], axis=0)
        elif u is not None:
            raise ValueError("model has n_ctrl=0 but u was given")
        else:
            z = x
        rho = jnp.asarray(self.forgetting, dtype=self._ab.dtype)
        self._ab, self._p = _rls_update(self._ab, self._p, z, y, rho)
        self.n_seen += int(x.shape[1])
        return self

    def fit_stream(self, x_data, u_data=None, batch: int = 64
                   ) -> "OnlineDmd":
        """Absorb a whole trajectory x_data (n, m) (consecutive columns
        form the m-1 pairs), u_data (q, m-1) or (q, m) (last column
        ignored), in fixed-size batches of ``batch`` pairs."""
        x_data = jnp.asarray(x_data, dtype=self._ab.dtype)
        if x_data.ndim != 2 or x_data.shape[0] != self.n_state:
            raise ValueError(
                f"x_data must be ({self.n_state}, m), got {x_data.shape}"
            )
        m = x_data.shape[1] - 1
        if m < 1:
            raise ValueError("need at least 2 snapshot columns")
        if self.n_ctrl > 0:
            u_data = self._coerce(u_data, self.n_ctrl, "u_data")
            if u_data.shape[1] not in (m, m + 1):
                raise ValueError(
                    f"u_data must have {m} or {m + 1} columns, got "
                    f"{u_data.shape[1]}"
                )
        for lo in range(0, m, batch):
            hi = min(lo + batch, m)
            self.update(
                x_data[:, lo:hi], x_data[:, lo + 1:hi + 1],
                u_data[:, lo:hi] if self.n_ctrl > 0 else None,
            )
        return self

    # -- read-out --------------------------------------------------------
    @property
    def a(self) -> jnp.ndarray:
        """Current state-transition estimate A (n, n)."""
        return self._ab[:, :self.n_state]

    @property
    def b(self) -> jnp.ndarray:
        """Current control-input estimate B (n, q)."""
        return self._ab[:, self.n_state:]

    def eig(self):
        """(eigenvalues, eigenvectors) of the current A — the DMD
        spectrum/modes of the streaming estimate (host eigensolver;
        complex numpy arrays, magnitude-sorted like ops/mat_utils
        sort_evd)."""
        lam, w = eig_host(self.a)
        order = np.argsort(-np.abs(np.asarray(lam)))
        return np.asarray(lam)[order], np.asarray(w)[:, order]

    def predict(self, x_0, u_seq=None, n_steps: int | None = None
                ) -> jnp.ndarray:
        """Roll the current (A, B) forward: returns (n, k) successor
        states. With controls, k = u_seq.shape[1]; without, pass
        n_steps."""
        x0 = jnp.asarray(x_0, dtype=self._ab.dtype).reshape(-1, 1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.shape[0]}"
            )
        if self.n_ctrl > 0:
            u = self._coerce(u_seq, self.n_ctrl, "u_seq")
            return _rollout_ab(self.a, self.b, x0, u)
        if n_steps is None:
            raise ValueError("n_ctrl=0 rollout needs n_steps")
        return _rollout_a(self.a, x0, jnp.zeros((int(n_steps),)))
