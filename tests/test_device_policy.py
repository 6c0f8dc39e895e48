"""Device failures propagate instead of turning into a CPU or other-engine
run, and the compile cache lives where the environment or the checkout
says."""
import pathlib

import numpy as np
import pytest

from cmsbwt_tpu.config import Config
from cmsbwt_tpu.engine import pipeline as pl
from cmsbwt_tpu.engine.pipeline import compute_bwt
from cmsbwt_tpu.utils import jaxcache

from helpers import make_inputs, mutate, random_dna

REPO = pathlib.Path(__file__).resolve().parent.parent


def _inputs(tmp_path, seed=21):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 500)
    return make_inputs(tmp_path, ref, [mutate(rng, ref, 0.01)
                                       for _ in range(2)])[0]


def test_jump_scan_failure_propagates(tmp_path, monkeypatch):
    from cmsbwt_tpu.ops import ms_jump

    def broken(*a, **kw):
        raise RuntimeError("jump scan failed on the device")

    monkeypatch.setattr(ms_jump, "ms_jump_heads", broken)
    cfg = Config(filename=str(_inputs(tmp_path)),
                 outname=str(tmp_path / "o"), backend="jump")
    with pytest.raises(RuntimeError, match="jump scan failed"):
        compute_bwt(cfg)
    assert not (tmp_path / "o.bwt").exists()


def test_device_index_failure_propagates_on_accelerator(tmp_path,
                                                        monkeypatch):
    from cmsbwt_tpu.index import device

    def broken(*a, **kw):
        raise RuntimeError("device index build failed")

    monkeypatch.setattr(device, "build_device_index", broken)
    monkeypatch.setattr(pl, "_on_accelerator", lambda: True)
    cfg = Config(filename=str(_inputs(tmp_path)),
                 outname=str(tmp_path / "o"), backend="native",
                 index_cache_dir="")
    with pytest.raises(RuntimeError, match="device index build failed"):
        compute_bwt(cfg)


def test_host_index_without_accelerator(monkeypatch):
    """No accelerator: the native engine's index is built by numpy, and
    the device builder is never asked."""
    from cmsbwt_tpu.index import device
    from cmsbwt_tpu.index.host import build_reference_index
    from cmsbwt_tpu.io.fasta import augment_reference

    def never(*a, **kw):
        raise AssertionError("device builder called on a CPU process")

    monkeypatch.setattr(device, "build_device_index", never)
    x = augment_reference(random_dna(np.random.default_rng(2), 300))
    got = pl._build_host_index_fast(x)
    np.testing.assert_array_equal(got.sa, build_reference_index(x).sa)


def test_backend_probe_failure_propagates(monkeypatch):
    """jax.devices() failing is an error, not a CPU answer, in every
    dispatcher that asks for the platform."""
    import jax

    def broken(*a, **kw):
        raise RuntimeError("backend init failed")

    monkeypatch.setattr(jax, "devices", broken)
    monkeypatch.delenv("CMSBWT_MERGE_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="backend init failed"):
        pl._on_accelerator()
    with pytest.raises(RuntimeError, match="backend init failed"):
        pl._resolve_merge_backend("auto")
    with pytest.raises(RuntimeError, match="backend init failed"):
        pl._resolve_backend("auto", coll_chars=10 * pl.AUTO_DENSE_MIN_CHARS)


@pytest.mark.parametrize("env, want", [
    ("/some/cache/dir", "/some/cache/dir"),
    (None, str(REPO / ".jax_cache")),
    ("", str(REPO / ".jax_cache")),
])
def test_compilation_cache_dir(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert jaxcache.compilation_cache_dir() == want


def test_repo_cache_dir_is_ignored_by_git():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_cache_enabled_at_env_dir(tmp_path, monkeypatch):
    """With CMSBWT_FORCE_CACHE past the CPU skip, the cache lands in
    JAX_COMPILATION_CACHE_DIR and nowhere else."""
    import jax
    cache = tmp_path / "xla"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
    monkeypatch.setenv("CMSBWT_FORCE_CACHE", "1")
    monkeypatch.setattr(jaxcache, "_DONE", False)
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        jaxcache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(cache)
        assert cache.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_cpu_process_skips_cache(monkeypatch):
    import jax
    monkeypatch.delenv("CMSBWT_FORCE_CACHE", raising=False)
    monkeypatch.setattr(jaxcache, "_DONE", False)
    before = jax.config.jax_compilation_cache_dir
    jaxcache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
