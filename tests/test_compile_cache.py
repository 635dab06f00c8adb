"""The compilation-cache helper every entry point calls."""

import jax
import pytest

from videorenderer import compile_cache


@pytest.fixture
def gpu_backend(monkeypatch):
    """Pretend the backend is a GPU, restoring the cache settings after."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_default_dir_is_fixed_checkout_path(gpu_backend, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    root = compile_cache.Path(compile_cache.__file__).resolve().parents[1]
    assert got == str(root / ".jax_cache") == str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    # the same path on every call: the directory is part of the cache key
    assert compile_cache.enable_compile_cache() == got


def test_environment_variable_is_honoured(gpu_backend, monkeypatch,
                                          tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_stays_off_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
