"""Persistent compile cache placement (sph_pie_tpu.utils.compile_cache)."""

import jax
import pytest

from sph_pie_tpu.utils import compile_cache


@pytest.fixture
def cache_dir_config():
    """Restore JAX's cache directory setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the code sets no directory of its own
    assert jax.config.jax_compilation_cache_dir is None


def test_unset_env_uses_checkout_dir(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    want = compile_cache.CHECKOUT_CACHE_DIR
    assert got == str(want)
    assert want.name == ".jax_cache" and (want.parent / "chip_smoke.py").exists()
    assert jax.config.jax_compilation_cache_dir == str(want)
