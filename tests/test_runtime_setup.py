"""Compile-cache placement (common/jax_setup.py) and bench.py's device
yardsticks: peak bandwidth by device kind, refusal of a non-GPU run."""
import sys
from pathlib import Path

import jax
import pytest

from gramtools_tpu.common import jax_setup

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_sets_nothing(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x")
    jax.config.update("jax_compilation_cache_dir", "/x")
    assert jax_setup.compile_cache_dir() is None
    jax_setup.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == "/x"


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_setup.compile_cache_dir() == REPO / ".jax_cache"
    jax_setup.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache").is_dir()


def test_cache_dir_unset_outside_a_checkout(monkeypatch, tmp_path,
                                            restore_cache_dir):
    """An installed package (no pyproject.toml above it) sets no cache
    directory and creates nothing beside its install."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax_setup, "_ROOT", tmp_path)
    jax.config.update("jax_compilation_cache_dir", None)
    assert jax_setup.compile_cache_dir() is None
    jax_setup.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / ".jax_cache").exists()


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12)])
def test_hbm_peak_for_h100(kind, peak):
    import bench
    assert bench.hbm_peak_bytes(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA L4"])
def test_hbm_peak_unknown_kind_raises(kind):
    import bench
    with pytest.raises(ValueError, match="no peak bandwidth"):
        bench.hbm_peak_bytes(kind)


def test_bench_refuses_cpu_unless_asked(monkeypatch):
    import bench
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    bench.require_gpu_backend()          # explicit CPU smoke: allowed
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(SystemExit, match="measures on the GPU"):
        bench.require_gpu_backend()
