"""Small-problem CPU routing decision logic (utils/smallpath).

These tests run on the CPU backend where routing is inherently a no-op;
the decision logic is exercised by faking an accelerator default
backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.utils import smallpath


@pytest.fixture(autouse=True)
def _reset_threshold():
    smallpath.set_small_path_threshold(1 << 20)
    yield
    smallpath.set_small_path_threshold(1 << 20)


def test_noop_on_cpu_backend(rng):
    a = rng.standard_normal((8, 3))
    (out,) = smallpath.maybe_route_small(a)
    assert out is a  # cpu default backend -> unchanged


def test_threshold_get_set():
    smallpath.set_small_path_threshold(123)
    assert smallpath.small_path_threshold() == 123
    smallpath.set_small_path_threshold(0)
    assert smallpath.small_path_threshold() == 0


def test_routes_small_when_accelerator_default(rng, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    a = rng.standard_normal((8, 3))
    (out,) = smallpath.maybe_route_small(a)
    assert isinstance(out, jax.Array)
    assert out.committed
    assert out.devices() == {jax.devices("cpu")[0]}
    np.testing.assert_array_equal(np.asarray(out), a)


def test_respects_work_elems_override(rng, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    a = rng.standard_normal((4, 3))  # tiny input...
    (out,) = smallpath.maybe_route_small(a, work_elems=1 << 22)
    assert out is a  # ...but the declared work is big -> stay put


def test_respects_explicit_commitment(rng, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    dev = jax.devices()[1]
    a = jax.device_put(jnp.ones((4, 3)), dev)  # caller pinned placement
    (out,) = smallpath.maybe_route_small(a)
    assert out is a


def test_disabled_via_threshold(rng, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    smallpath.set_small_path_threshold(0)
    a = rng.standard_normal((8, 3))
    (out,) = smallpath.maybe_route_small(a)
    assert out is a


def test_sampler_routing_by_chains(rng, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    small = rng.standard_normal((12, 3))
    (out,) = smallpath.route_sampler_small(small, n_chains=12)
    assert isinstance(out, jax.Array) and out.committed
    big = rng.standard_normal((8192, 3))
    (out2,) = smallpath.route_sampler_small(big, n_chains=8192)
    assert out2 is big


def test_env_disable(monkeypatch):
    monkeypatch.setenv("CORRLA_SMALL_PATH", "0")
    smallpath._threshold = None  # force re-read
    assert smallpath.small_path_threshold() == 0
    smallpath._threshold = None
    monkeypatch.setenv("CORRLA_SMALL_PATH", "5000")
    assert smallpath.small_path_threshold() == 5000
    smallpath._threshold = None
    monkeypatch.delenv("CORRLA_SMALL_PATH")
    assert smallpath.small_path_threshold() == 0  # off by default


def test_models_still_fit_with_routing_active(rng, monkeypatch):
    # end-to-end: with a faked accelerator default, the small models fit
    # on the committed-CPU path and produce the same numbers
    from corrla_rs_tpu.models.pca import PcaRsvd

    x = rng.standard_normal((200, 6))
    ref = PcaRsvd(x, 3, key=1)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    routed = PcaRsvd(x, 3, key=1)
    np.testing.assert_allclose(
        np.asarray(routed.singular_values),
        np.asarray(ref.singular_values), rtol=1e-12,
    )
