"""Debug / NaN-check mode (SURVEY.md §5)."""
import jax.numpy as jnp
import numpy as np
import pytest

import corrla_rs_tpu as crt
from corrla_rs_tpu.utils.debug import checkified, debug_enabled, guard_finite


@pytest.fixture
def debug_mode():
    crt.set_debug(True)
    yield
    crt.set_debug(False)


def test_poisoned_input_reports_located_error(debug_mode, rng):
    a = rng.standard_normal((40, 10)).astype(np.float32)
    a[3, 7] = np.nan
    with pytest.raises(crt.NonFiniteError, match="rsvd input"):
        crt.rsvd(jnp.asarray(a), 3, 6, 4)


def test_poisoned_output_reports(debug_mode):
    # all-inf input sails through the input check only if finite... use a
    # function whose OUTPUT poisons: rsvd of an overflow-scaled matrix in
    # f32 produces non-finite singular vectors
    a = jnp.full((20, 6), 1e38, jnp.float32)
    with pytest.raises(crt.NonFiniteError):
        crt.rsvd(a, 2, 4, 2)


def test_disabled_mode_is_silent(rng):
    assert not debug_enabled()
    a = rng.standard_normal((40, 10)).astype(np.float32)
    a[0, 0] = np.nan
    u, s, vt = crt.rsvd(jnp.asarray(a), 3, 6, 4)  # no raise (legacy behavior)
    assert not np.isfinite(np.asarray(s)).all()


def test_guard_finite_decorator_passthrough(debug_mode):
    @guard_finite
    def f(x, label="ok"):
        return x * 2.0

    out = f(jnp.ones((3,)))
    np.testing.assert_allclose(np.asarray(out), 2.0)
    with pytest.raises(crt.NonFiniteError, match="f input"):
        f(jnp.asarray([1.0, np.inf]))


def test_checkified_locates_nan_op(rng):
    # in-jit located checks (CPU-class backends)
    from jax.experimental import checkify

    def f(x):
        y = jnp.log(x)        # NaN for negative entries
        return jnp.sum(y * 2.0)

    fc = checkified(f)
    assert np.isfinite(fc(jnp.asarray([1.0, 2.0])))
    with pytest.raises(checkify.JaxRuntimeError, match="nan"):
        fc(jnp.asarray([-1.0, 2.0]))
