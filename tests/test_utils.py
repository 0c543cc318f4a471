"""Utility-module tests (tracing, cache, prng, config, log)."""
import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.utils.config import (
    DmdConfig,
    DreamConfig,
    PcaConfig,
    RsvdConfig,
)
from corrla_rs_tpu.utils.log import get_logger
from corrla_rs_tpu.utils.prng import as_key, split_key
from corrla_rs_tpu.utils.tracing import timed


def test_as_key_forms():
    k1 = as_key(7)
    k2 = as_key(jax.random.key(7))
    assert jax.dtypes.issubdtype(k1.dtype, jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        jax.random.key_data(k1), jax.random.key_data(k2)
    )
    k3 = as_key(None)
    assert jax.dtypes.issubdtype(k3.dtype, jax.dtypes.prng_key)
    # traced integer seed
    out = jax.jit(lambda s: jax.random.uniform(as_key(s)))(3)
    assert 0.0 <= float(out) <= 1.0


def test_split_key():
    ks = split_key(0, 4)
    assert ks.shape[0] == 4


def test_timed_and_sync(rng):
    a = jnp.asarray(rng.standard_normal((64, 64)))
    wall, out = timed(lambda: a @ a, n_runs=2)
    assert wall >= 0.0
    assert out.shape == (64, 64)
    # pytrees with host numpy arrays, empties and None time as well
    wall, out = timed(lambda: [np.ones(3), jnp.zeros((0,)), None, a], n_runs=1)
    assert wall >= 0.0 and out[3].shape == (64, 64)


def test_configs_frozen_defaults():
    assert PcaConfig().n_iter == 20          # pca_rsvd.rs:66
    assert DmdConfig().n_oversamples == 12   # dmd_rom.rs:72
    assert RsvdConfig().n_oversamples == 10
    assert DreamConfig().delta_max == 3
    import dataclasses
    import pytest

    with pytest.raises(dataclasses.FrozenInstanceError):
        PcaConfig().n_iter = 5


def test_configs_are_consumed_by_library():
    # utils/config.py must not be decorative: the dataclasses are
    # now the single source of the model/sampler defaults...
    from corrla_rs_tpu.models import active_subspaces, dmd, pca, pod
    from corrla_rs_tpu.ops import dream, samplers
    import inspect

    assert pca.PCA_N_ITER == PcaConfig().n_iter
    assert pca.PCA_MAX_OVERSAMPLES == PcaConfig().max_oversamples
    assert dmd.DMD_N_OVERSAMPLES == DmdConfig().n_oversamples
    assert active_subspaces.ASS_N_ITER == 8
    assert pod.POD_N_ITER == 10
    assert (inspect.signature(dream.dream_run).parameters["delta_max"].default
            == DreamConfig().delta_max)
    assert (inspect.signature(samplers.DeMcSampler.__init__)
            .parameters["gamma"].default == 0.8)


def test_config_objects_override_model_defaults(rng):
    # ...and a config= object actually changes fitted behavior.
    import jax.numpy as jnp

    from corrla_rs_tpu import PcaRsvd

    x = jnp.asarray(rng.standard_normal((60, 8)))
    p_default = PcaRsvd(x, 3)
    p_cfg = PcaRsvd(x, 3, config=PcaConfig(n_iter=2, max_oversamples=2))
    assert p_cfg._n_iter == 2 and p_cfg._max_oversamples == 2
    # both still fit validly
    assert p_default.singular_values.shape == (3,)
    assert p_cfg.singular_values.shape == (3,)


def test_make_mesh_2d_from_config():
    import jax

    from corrla_rs_tpu.parallel.mesh import make_mesh_2d
    from corrla_rs_tpu.utils.config import MeshConfig

    if len(jax.devices()) >= 8:
        mesh = make_mesh_2d(MeshConfig(rows=4, chains=2))
        assert mesh.shape == {"rows": 4, "chains": 2}
    import pytest

    with pytest.raises(ValueError):
        make_mesh_2d(MeshConfig(rows=1000, chains=1000))


def test_logger():
    lg = get_logger()
    assert lg.name == "corrla_rs_tpu"
    lg.info("no-op with NullHandler")


def test_rank_normalized_rhat(rng):
    from corrla_rs_tpu.ops.diagnostics import rank_normalized_rhat

    # well-mixed chains: all statistics near 1
    good = rng.standard_normal((400, 8, 2))
    r = np.asarray(rank_normalized_rhat(good))
    assert r.shape == (2,)
    assert (r < 1.05).all(), r
    # scale-only mixing failure: same mean, very different variances —
    # plain location-based R-hat stays low, the folded statistic fires
    bad = rng.standard_normal((400, 8, 1))
    bad[:, :4, 0] *= 6.0
    from corrla_rs_tpu.ops.diagnostics import gelman_rubin

    r_plain = float(np.asarray(gelman_rubin(bad))[0])
    r_rank = float(np.asarray(rank_normalized_rhat(bad))[0])
    assert r_rank > 1.2, (r_plain, r_rank)
    assert r_rank > r_plain
