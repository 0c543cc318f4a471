"""Where the persistent compilation cache lands (utils/cache)."""
import pathlib

import jax
import pytest

from corrla_rs_tpu.utils import cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_persistent_cache()
    got = pathlib.Path(jax.config.jax_compilation_cache_dir)
    assert got == REPO / ".jax_cache" / cache.host_feature_tag()
    # stable: no pid, time or temporary name in the path
    assert cache.cache_dir() == str(got)
