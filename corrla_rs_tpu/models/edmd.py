"""Extended DMD (Koopman operator with dictionaries) — EXTENSION.

The reference's ROM family is linear-observable only (DMDc,
dmd_rom.rs:45-109; plain DMD in models/dmd.py): it can only represent
dynamics that are linear in the state itself. EDMD (Williams,
Kevrekidis & Rowley 2015) lifts the state through a dictionary of
observables psi: R^n -> R^N and fits the finite-dimensional Koopman
approximation K (N, N) with

    psi(x_{t+1}) ~= K psi(x_t),
    K = (Psi_y Psi_x^T)(Psi_x Psi_x^T + ridge I)^{-1},

so NONLINEAR systems whose dynamics live in (or near) a
Koopman-invariant subspace of the dictionary get an exactly linear
lifted model: spectrum, eigenfunctions phi_j(x) = (V^{-1} psi(x))_j,
Koopman modes (columns of V restricted to the state rows), and linear
prediction in the lifted space.

The dictionary ALWAYS contains the state coordinates themselves (and
optionally a constant), prepended to whatever the user supplies —
this guarantees x = C psi(x) with C a row selector, which is what makes
mode extraction and rollouts exact rather than approximate.

Accelerator shape: the fit is ONE jitted kernel — two (N, N) Gram matmuls at
HIGHEST precision plus one symmetric solve (no pinv); dictionaries are
jittable column maps evaluated on device; rollouts are a real-valued
``lax.scan`` over the lifted state (the complex spectral algebra stays
on host numpy like models/dmd.py).
Spectrum of the N x N K uses the host eigensolver (ops/eig.eig_host).
"""
from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.eig import eig_host
from corrla_rs_tpu.ops.mat_utils import PRECISION
from corrla_rs_tpu.utils.checkpoint import register_model_class

__all__ = ["Edmd", "poly_exponents"]


def poly_exponents(n_state: int, degree: int) -> np.ndarray:
    """Exponent matrix (n_feat, n_state) of all monomials with total
    degree in [2, degree] (constant and linear terms are excluded —
    Edmd always provides those itself)."""
    if degree < 2:
        return np.zeros((0, n_state), np.int32)
    exps = [
        e
        for e in itertools.product(range(degree + 1), repeat=n_state)
        if 2 <= sum(e) <= degree
    ]
    return np.asarray(exps, np.int32)


def _poly_features(x, exps):
    # (n_feat, n, 1) exponents against (1, n, c) states -> prod over n
    return jnp.prod(
        x[None, :, :] ** exps[:, :, None].astype(x.dtype), axis=1
    )


def _rbf_features(x, centers, gamma):
    # centers (n_c, n); x (n, c) -> (n_c, c) gaussian bumps
    d2 = (
        jnp.sum(centers * centers, axis=1)[:, None]
        - 2.0 * jnp.matmul(centers, x, precision=PRECISION)
        + jnp.sum(x * x, axis=0)[None, :]
    )
    return jnp.exp(-gamma * jnp.maximum(d2, 0.0))


@jax.jit
def _edmd_fit_kernel(psi_x, psi_y, ridge):
    """Returns (K, G, C, L): the operator plus the three snapshot Grams
    G = Psi_x Psi_x^T / c, C = Psi_y Psi_x^T / c, L = Psi_y Psi_y^T / c
    (unregularized — ResDMD residuals need the true mass matrix)."""
    n_feat, c = psi_x.shape
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    scale = 1.0 / c
    g = mm(psi_x, psi_x.T) * scale
    a = mm(psi_y, psi_x.T) * scale
    l_ = mm(psi_y, psi_y.T) * scale
    reg = ridge * (jnp.trace(g) / n_feat + 1e-30)
    g_reg = g + reg * jnp.eye(n_feat, dtype=g.dtype)
    # K = A G^{-1}; G symmetric -> K^T = G^{-1} A^T via one solve
    return jnp.linalg.solve(g_reg, a.T).T, g, a, l_


@functools.partial(jax.jit, static_argnames=("n_upto",))
def _lift_rollout(k_op, psi0, n_steps_zeros, n_upto):
    def step(psi, _):
        psi_next = jnp.matmul(k_op, psi, precision=PRECISION)
        return psi_next, psi_next[:n_upto, 0]

    _, xs = lax.scan(step, psi0, n_steps_zeros)
    return xs.T


@register_model_class
class Edmd:
    """Koopman EDMD model fitted from a trajectory (or snapshot pairs).

    Parameters
    ----------
    x_data : (n, m) snapshot columns. Consecutive columns form the m-1
        training pairs unless ``y_data`` (n, m) gives the successors
        explicitly (then all m columns pair with y_data's).
    dictionary : 'poly' (default), 'rbf', 'linear', or a jittable
        callable (n, c) -> (N_user, c). 'linear' adds nothing beyond
        the state (EDMD degenerates to full-state DMD). Custom-callable
        dictionaries work everywhere except ``save_model`` (a closure
        cannot round-trip through npz).
    degree : total degree for 'poly' (monomials of degree 2..degree;
        the state and constant are always present separately).
    centers : (n_centers, n) RBF centers for 'rbf' (required there).
    gamma : RBF inverse squared length-scale.
    include_const : prepend a constant-1 observable (default True; the
        constant absorbs fixed points away from the origin).
    ridge : relative Tikhonov weight on the lifted Gram.

    Attributes after fit: ``koopman`` (N, N) real device array;
    ``lambdas`` complex (N,) host spectrum, magnitude-sorted;
    ``modes`` complex (n, N) host Koopman modes (columns);
    ``eigenfunctions(x)`` evaluates all N eigenfunctions at state
    columns x.
    """

    def __init__(self, x_data, dictionary="poly", degree: int = 2,
                 centers=None, gamma: float = 1.0,
                 include_const: bool = True, ridge: float = 1.0e-10,
                 y_data=None):
        if not (callable(dictionary)
                or dictionary in ("poly", "rbf", "linear")):
            raise ValueError(
                "dictionary must be 'poly', 'rbf', 'linear' or a "
                f"callable, got {dictionary!r}"
            )
        if dictionary == "rbf" and centers is None:
            raise ValueError("dictionary='rbf' requires centers")
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        (x_data,) = maybe_route_small(x_data)
        x = jnp.asarray(x_data)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError(
                f"x_data must be (n, m >= 2), got {np.shape(x_data)}"
            )
        self.n_state = int(x.shape[0])
        self.include_const = bool(include_const)
        self.ridge = float(ridge)
        self.degree = int(degree)
        self.gamma = float(gamma)
        if callable(dictionary):
            self._dict_kind = "custom"
            self._psi_user = dictionary
        else:
            self._dict_kind = dictionary
        if self._dict_kind == "poly":
            self._exps = jnp.asarray(
                poly_exponents(self.n_state, self.degree)
            )
        elif self._dict_kind == "rbf":
            self._centers = jnp.asarray(centers, dtype=x.dtype)
            if self._centers.ndim != 2 \
                    or self._centers.shape[1] != self.n_state:
                raise ValueError(
                    f"centers must be (n_centers, {self.n_state}), got "
                    f"{np.shape(centers)}"
                )

        if y_data is None:
            psi_x = self.lift(x[:, :-1])
            psi_y = self.lift(x[:, 1:])
        else:
            y = jnp.asarray(y_data, dtype=x.dtype)
            if y.shape != x.shape:
                raise ValueError(
                    f"y_data shape {y.shape} != x_data shape {x.shape}"
                )
            psi_x = self.lift(x)
            psi_y = self.lift(y)
        self.n_features = int(psi_x.shape[0])
        self.koopman, self._gram_g, self._gram_c, self._gram_l = \
            _edmd_fit_kernel(
                psi_x, psi_y, jnp.asarray(self.ridge, x.dtype)
            )

        lam, v = eig_host(self.koopman)
        order = np.argsort(-np.abs(lam))
        lam, v = lam[order], v[:, order]
        self.lambdas = lam
        self._v = v
        self._w = np.linalg.inv(v)          # phi(x) = W psi(x)
        off = 1 if self.include_const else 0
        self.modes = v[off:off + self.n_state, :]

    # -- lifting ---------------------------------------------------------
    def lift(self, x) -> jnp.ndarray:
        """psi(x): (n, c) state columns -> (N, c) observable columns,
        ordered [const?; x; user features]."""
        x = jnp.asarray(x)
        one_d = x.ndim == 1
        if one_d:
            x = x[:, None]
        if x.shape[0] != self.n_state:
            raise ValueError(
                f"x must have {self.n_state} rows, got {x.shape[0]}"
            )
        blocks = []
        if self.include_const:
            blocks.append(jnp.ones((1, x.shape[1]), x.dtype))
        blocks.append(x)
        if self._dict_kind == "poly":
            if self._exps.shape[0]:
                blocks.append(_poly_features(x, self._exps))
        elif self._dict_kind == "rbf":
            blocks.append(_rbf_features(x, self._centers, self.gamma))
        elif self._dict_kind == "custom":
            blocks.append(jnp.asarray(self._psi_user(x), dtype=x.dtype))
        return jnp.concatenate(blocks, axis=0)

    # -- read-out --------------------------------------------------------
    def eigenfunctions(self, x) -> np.ndarray:
        """phi(x) (N, c) complex host array: row j is the j-th Koopman
        eigenfunction evaluated at each state column (same magnitude-
        sorted order as ``lambdas``)."""
        return self._w @ np.asarray(self.lift(x))

    def residuals(self) -> np.ndarray:
        """ResDMD relative residuals, one per eigenpair (Colbrook &
        Townsend 2021/2024): for eigenfunction phi_j with coefficient
        row u = W[j, :],

          res_j^2 = mean_t |phi_j(x_{t+1}) - lambda_j phi_j(x_t)|^2
                    / mean_t |phi_j(x_t)|^2

        computed exactly from the stored snapshot Grams (G, C, L) — no
        re-lifting. EDMD eigenvalues are Galerkin artifacts unless this
        residual is small ("spectral pollution"); genuine Koopman
        spectrum has res ~ 0 on invariant subspaces. Order matches
        ``lambdas``.
        """
        g = np.asarray(self._gram_g, np.float64)
        c_ = np.asarray(self._gram_c, np.float64)
        l_ = np.asarray(self._gram_l, np.float64)
        out = np.empty(self._w.shape[0])
        for j in range(self._w.shape[0]):
            u = self._w[j, :]
            lam = self.lambdas[j]
            uc = np.conj(u)

            def q(m, u=u, uc=uc):
                return np.dot(u, m @ uc)

            den = np.real(q(g))
            num = np.real(
                q(l_) - np.conj(lam) * q(c_) - lam * q(c_.T)
                + np.abs(lam) ** 2 * q(g)
            )
            out[j] = np.sqrt(max(num, 0.0) / max(den, 1e-300))
        return out

    def validated_spectrum(self, eps: float = 1e-2):
        """(lambdas, residuals) restricted to eigenpairs with ResDMD
        residual <= eps — the spectral-pollution filter."""
        res = self.residuals()
        keep = res <= float(eps)
        return self.lambdas[keep], res[keep]

    def predict(self, x_0, n_steps: int, relift: bool = False
                ) -> jnp.ndarray:
        """Forecast (n, n_steps) from state ``x_0``.

        relift=False (default): linear rollout in the LIFTED space —
        psi_{k+1} = K psi_k, read off the state rows. Exact iff the
        dictionary spans a Koopman-invariant subspace; the honest
        Koopman forecast.
        relift=True: re-lift the predicted state every step
        (x_{k+1} = C K psi(x_k)) — a one-step-ahead model iterated,
        often tighter off-manifold but no longer linear.
        """
        x0 = jnp.asarray(x_0).reshape(-1, 1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.shape[0]}"
            )
        n_steps = int(n_steps)
        off = 1 if self.include_const else 0
        if not relift:
            psi0 = self.lift(x0)
            out = _lift_rollout(
                self.koopman, psi0, jnp.zeros((n_steps,)),
                off + self.n_state,
            )
            return out[off:, :]
        xs = []
        xk = x0
        for _ in range(n_steps):
            psi_next = jnp.matmul(
                self.koopman, self.lift(xk), precision=PRECISION
            )
            xk = psi_next[off:off + self.n_state, :]
            xs.append(xk[:, 0])
        return jnp.stack(xs, axis=1)
