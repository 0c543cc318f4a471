"""Poly-augmented RBF interpolation.

Parity with reference interp_utils.rs:11-153 (``RbfInterp`` + 4 kernels).
Design: the reference builds the kernel matrix with an O(n^2) scalar
double loop (interp_utils.rs:96-106); here it is one broadcasted
pairwise-distance computation that XLA fuses elementwise, and the
saddle system [[K, P], [P^T, 0]] is solved for *all* right-hand-side columns
at once — fitting m outputs over the same support points costs one solve
(the reference fits one ``RbfInterp`` per output, e.g. pod_rom.rs:78-95).

Kernel-type integer codes match the pyo3 binding
(lib_math_utils_py.rs:187-193): 1=linear, 2=multiquadric, 3=cubic,
anything else=gaussian.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from corrla_rs_tpu.ops.mat_utils import PRECISION, pinv
from corrla_rs_tpu.ops.stats_corr import build_full_vandermonde

__all__ = ["RbfInterp", "pairwise_dists", "rbf_kernel_eval", "rbf_fit", "rbf_predict"]

_KERNEL_NAMES = {1: "linear", 2: "multiquadric", 3: "cubic"}


def pairwise_dists(xa: jnp.ndarray, xb: jnp.ndarray) -> jnp.ndarray:
    """Euclidean distance matrix (n_a, n_b).

    Computed as the directly broadcasted difference norm (elementwise,
    XLA-fused — no (n_a, n_b, d) materialization). The Gram-expansion
    matmul form ||a||^2 - 2 a.b + ||b||^2 is avoided: it cancels
    catastrophically for near points, and the feature dims in this
    library are small, so there is no matmul worth having.
    """
    diff = xa[:, None, :] - xb[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    return jnp.sqrt(d2)


def rbf_kernel_eval(r: jnp.ndarray, kernel: str, eps: float) -> jnp.ndarray:
    """Evaluate an RBF kernel elementwise on distances.

    Kernels (interp_utils.rs:31-80): linear r, cubic r^3,
    multiquadric sqrt(1 + (eps r)^2), gaussian exp(-(eps r)^2).
    Dispatch is resolved at trace time (static string), so the jitted
    program contains only the selected kernel.
    """
    if kernel == "linear":
        return r
    if kernel == "cubic":
        return r * r * r
    if kernel == "multiquadric":
        return jnp.sqrt(1.0 + (eps * r) ** 2)
    if kernel == "gaussian":
        return jnp.exp(-((r * eps) ** 2))
    raise ValueError(f"unknown RBF kernel: {kernel!r}")


@functools.partial(jax.jit, static_argnames=("kernel", "poly_degree", "method"))
def rbf_fit(x: jnp.ndarray, y: jnp.ndarray, kernel: str, eps: float,
            poly_degree: int, method: str = "solve") -> jnp.ndarray:
    """Solve the poly-augmented RBF saddle system for coefficients.

    Block system [[K, P], [P^T, 0]] @ c = [y; 0], parity with
    interp_utils.rs:131-144. y may have multiple columns; returns
    (n + p, y_cols).

    method:
      - 'solve' (default): LU solve — backward stable, far more accurate
        than the explicit pinv product in f32 (the saddle system is
        ill-conditioned).
      - 'pinv': the reference's eps-regularized pseudoinverse
        (interp_utils.rs:139-142) — bitwise-parity semantics; prefer in f64.
    """
    k_mat = rbf_kernel_eval(pairwise_dists(x, x), kernel, eps)
    p_mat = build_full_vandermonde(x, poly_degree)
    n, p = p_mat.shape
    upper = jnp.concatenate([k_mat, p_mat], axis=1)
    lower = jnp.concatenate(
        [p_mat.T, jnp.zeros((p, p), x.dtype)], axis=1
    )
    kp = jnp.concatenate([upper, lower], axis=0)
    y_pad = jnp.concatenate([y, jnp.zeros((p, y.shape[1]), y.dtype)], axis=0)
    if method == "pinv":
        return jnp.matmul(pinv(kp), y_pad, precision=PRECISION)
    return jnp.linalg.solve(kp, y_pad)


@functools.partial(jax.jit, static_argnames=("kernel", "poly_degree"))
def rbf_predict(x_known: jnp.ndarray, coeffs: jnp.ndarray, x_query: jnp.ndarray,
                kernel: str, eps: float, poly_degree: int) -> jnp.ndarray:
    """Evaluate the fitted interpolant at query points. interp_utils.rs:146-153."""
    k_q = rbf_kernel_eval(pairwise_dists(x_query, x_known), kernel, eps)
    p_q = build_full_vandermonde(x_query, poly_degree)
    return jnp.matmul(
        jnp.concatenate([k_q, p_q], axis=1), coeffs, precision=PRECISION
    )


class RbfInterp:
    """RBF interpolator with polynomial augmentation.

    Signature mirrors PyRbfInterp (lib_math_utils_py.rs:186-198):
    ``RbfInterp(kernel_type, kernel_param, dim, poly_degree)`` where
    kernel_type is 1=linear, 2=multiquadric, 3=cubic, else gaussian —
    or a kernel name string.
    """

    def __init__(self, kernel_type=1, kernel_param: float = 1.0, dim: int = 1,
                 poly_degree: int = 1, method: str = "solve"):
        if isinstance(kernel_type, str):
            self.kernel = kernel_type
        else:
            self.kernel = _KERNEL_NAMES.get(int(kernel_type), "gaussian")
        self.eps = float(kernel_param)
        self.rbf_dim = int(dim)
        self.poly_degree = int(poly_degree)
        self.method = method
        self.x_known = None
        self.coeffs = None

    def fit(self, x_in, y_in):
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        # the saddle solve is O(n^2)-shaped: route by the kernel-matrix
        # size, not the input size
        n = np.shape(x_in)[0]
        x_in, y_in = maybe_route_small(x_in, y_in, work_elems=n * n)
        x = jnp.asarray(x_in)
        y = jnp.asarray(y_in)
        if y.ndim == 1:
            y = y[:, None]
        assert x.shape[1] == self.rbf_dim, (
            f"expected dim {self.rbf_dim}, got {x.shape[1]}"
        )
        self.x_known = x
        self.coeffs = rbf_fit(
            x, y, self.kernel, self.eps, self.poly_degree, self.method
        )
        return self

    def predict(self, x_query) -> jnp.ndarray:
        xq = jnp.asarray(x_query)
        assert xq.shape[1] == self.rbf_dim
        return rbf_predict(
            self.x_known, self.coeffs, xq, self.kernel, self.eps,
            self.poly_degree,
        )
