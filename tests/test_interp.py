"""RBF interpolation tests (reference interp_utils.rs:157-184)."""
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.interp import (
    RbfInterp,
    pairwise_dists,
    rbf_kernel_eval,
)
from corrla_rs_tpu.utils.testing import assert_mat_approx_eq


def test_pairwise_dists(rng):
    xa = jnp.asarray(rng.standard_normal((7, 3)))
    xb = jnp.asarray(rng.standard_normal((5, 3)))
    d = pairwise_dists(xa, xb)
    expect = np.linalg.norm(
        np.asarray(xa)[:, None, :] - np.asarray(xb)[None, :, :], axis=-1
    )
    assert_mat_approx_eq(d, expect, 1e-10)


def test_kernel_values():
    r = jnp.array([0.0, 1.0, 2.0])
    assert_mat_approx_eq(rbf_kernel_eval(r, "linear", 1.0), r)
    assert_mat_approx_eq(rbf_kernel_eval(r, "cubic", 1.0), r**3)
    assert_mat_approx_eq(
        rbf_kernel_eval(r, "multiquadric", 0.5),
        jnp.sqrt(1.0 + (0.5 * r) ** 2),
    )
    assert_mat_approx_eq(
        rbf_kernel_eval(r, "gaussian", 0.5), jnp.exp(-((0.5 * r) ** 2))
    )


def test_kernel_type_codes():
    # pyo3 mapping (lib_math_utils_py.rs:187-193)
    assert RbfInterp(1, 1.0, 2, 1).kernel == "linear"
    assert RbfInterp(2, 1.0, 2, 1).kernel == "multiquadric"
    assert RbfInterp(3, 1.0, 2, 1).kernel == "cubic"
    assert RbfInterp(99, 1.0, 2, 1).kernel == "gaussian"


def test_rbf_interp_exact_at_support(rng):
    # An interpolant passes (near-)exactly through its support points.
    x = jnp.asarray(rng.standard_normal((40, 2)))
    y = (jnp.sin(x[:, 0]) + jnp.sin(x[:, 1]))[:, None]
    rbf = RbfInterp(2, 1.0, 2, 1).fit(x, y)
    y_hat = rbf.predict(x)
    assert_mat_approx_eq(y_hat, y, 1e-6)


def test_rbf_interp_generalizes(rng):
    # Parity fixture with interp_utils.rs:163-183: smooth 2-D function,
    # multiquadric kernel; check generalization error is small.
    x = jnp.asarray(rng.standard_normal((200, 2)))
    y = (jnp.sin(x[:, 0]) + jnp.sin(x[:, 1]))[:, None]
    rbf = RbfInterp(2, 1.0, 2, 1).fit(x, y)
    xq = jnp.asarray(rng.standard_normal((50, 2)) * 0.8)
    yq_true = (jnp.sin(xq[:, 0]) + jnp.sin(xq[:, 1]))[:, None]
    yq = rbf.predict(xq)
    assert float(jnp.max(jnp.abs(yq - yq_true))) < 0.1


@pytest.mark.parametrize("kernel_type", [1, 2, 3, 0])
def test_all_kernels_fit_1d(rng, kernel_type):
    x = jnp.linspace(0.0, 4.0, 25)[:, None]
    y = jnp.cos(x)
    rbf = RbfInterp(kernel_type, 1.0, 1, 1).fit(x, y)
    xq = jnp.linspace(0.5, 3.5, 11)[:, None]
    yq = rbf.predict(xq)
    assert float(jnp.max(jnp.abs(yq - jnp.cos(xq)))) < 0.05


def test_multi_output_fit(rng):
    # Batched outputs: one solve for many columns (used by POD).
    x = jnp.asarray(rng.standard_normal((30, 2)))
    y = jnp.stack([jnp.sin(x[:, 0]), jnp.cos(x[:, 1])], axis=1)
    rbf = RbfInterp(3, 1.0, 2, 1).fit(x, y)
    y_hat = rbf.predict(x)
    assert y_hat.shape == (30, 2)
    assert_mat_approx_eq(y_hat, y, 1e-5)


def _kernel_f64(r, kernel, eps):
    return {
        "linear": r,
        "cubic": r ** 3,
        "multiquadric": np.sqrt(1.0 + (eps * r) ** 2),
        "gaussian": np.exp(-((eps * r) ** 2)),
    }[kernel]


@pytest.mark.parametrize(
    "kernel,n_a,n_b,d",
    [
        ("linear", 70, 50, 3),
        ("multiquadric", 70, 50, 3),
        ("cubic", 70, 50, 3),
        ("gaussian", 70, 50, 3),
        # shapes that are not multiples of any tile or power of two
        ("multiquadric", 7, 13, 2),
    ],
)
def test_kernel_matrix_f32_matches_float64(rng, kernel, n_a, n_b, d):
    # the XLA kernel-matrix path in f32 against float64 numpy on the same
    # (f32-rounded) points: elementwise f32 rounding only
    xa = rng.standard_normal((n_a, d)).astype(np.float32)
    xb = rng.standard_normal((n_b, d)).astype(np.float32)
    got = rbf_kernel_eval(
        pairwise_dists(jnp.asarray(xa), jnp.asarray(xb)), kernel, 0.7
    )
    assert got.dtype == jnp.float32 and got.shape == (n_a, n_b)
    r = np.sqrt(((xa.astype(np.float64)[:, None, :]
                  - xb.astype(np.float64)[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(
        np.asarray(got, np.float64), _kernel_f64(r, kernel, 0.7),
        rtol=2e-6, atol=1e-6,
    )
