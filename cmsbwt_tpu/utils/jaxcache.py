"""Persistent XLA compilation cache: a large-shape compile costs seconds
to minutes, and caching makes it once per cache directory. Combined with
shape bucketing (ops/ms_dense.py pads inputs to size buckets) recompiles
become rare across runs."""
from __future__ import annotations

import os
import pathlib

_DONE = False
_REPO = pathlib.Path(__file__).resolve().parents[2]


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``:
    a fixed path, because the path is part of the cache's key."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_REPO / ".jax_cache"))


def enable_compilation_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax
    # CPU-only processes skip the persistent cache: CPU compiles are
    # milliseconds, and jax's cache read (get_executable_and_time) has
    # segfaulted test processes sharing the directory with concurrent
    # runs.
    if (not os.environ.get("CMSBWT_FORCE_CACHE")
            and all(d.platform == "cpu" for d in jax.devices())):
        return
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_RATIO = float(os.environ.get("CMSBWT_BUCKET_RATIO", "1.08"))


def bucket_size(x: int, ratio: float | None = None,
                minimum: int = 1 << 12) -> int:
    """Smallest geometric bucket >= x (stabilizes jit shapes).

    The default ratio trades pad waste (every sort pass carries the pad)
    against compile count: 1.08 caps the dead weight at 8% (measured 23%
    at the 20 Mchar bench config under the old 1.25). The persistent XLA
    cache (enable_compilation_cache) absorbs the extra first-run compiles.
    Override via CMSBWT_BUCKET_RATIO."""
    b = minimum
    r = _RATIO if ratio is None else ratio
    while b < x:
        b = int(b * r) + 1
    return b
