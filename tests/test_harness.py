"""Run-time harness pieces: the compile-cache helper and chip_smoke.py's
refusal to run without a GPU."""
import importlib.util
from pathlib import Path

import jax
import pytest

from fusion_cryptography_tpu.utils import cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs,
             jax.config.jax_include_full_tracebacks_in_locations)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    jax.config.update("jax_include_full_tracebacks_in_locations", saved[2])


def test_cache_dir_from_env_is_left_to_jax(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set here


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # one frame per op location: a kernel's cache key ignores its callers
    assert not jax.config.jax_include_full_tracebacks_in_locations


def test_chip_smoke_refuses_a_cpu_device():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        mod.check_device(jax)
