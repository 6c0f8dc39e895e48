"""Concurrent AOT compilation ("prewarm") of known-shape jit programs.

Why: every UNCACHED jit dispatch pays the XLA compile (multi-operand
``lax.sort`` comparators cost the most, growing with operand count and
nearly independent of array size), and a cold-cache pipeline run
compiles ~25 programs SERIALLY. Compiles of independent programs can run
concurrently, so every program whose shapes are already known is fired
into a background thread, and the main thread waits for a program only
right before its first call. What this saves on the GPU, where most
programs may compile in under the persistent cache's 1 s floor, awaits
measurement.

Mechanics: ``Wave.add`` lowers the jitted function AOT with
``jax.ShapeDtypeStruct`` args (no dummy data, nothing executes) and
compiles it on a daemon thread; the resulting executable lands in the
persistent XLA compilation cache (utils/jaxcache), so the main thread's
normal dispatch gets a cache hit instead of a cold compile.
``Wave.ready(name)`` blocks until that program's compile finished (or
failed — prewarm is best-effort: a failure just means the dispatch path
compiles as before).

Enabled by default only on accelerators (CPU XLA compiles in
milliseconds); force with CMSBWT_PREWARM=1 / disable with =0.
"""
from __future__ import annotations

import os
import threading

_MAX_WAIT_S = float(os.environ.get("CMSBWT_PREWARM_WAIT_S", "900"))

# (fn, avals, statics) combinations already prewarmed this process: repeat
# runs must not re-fire background compiles — even cache-hit lowering
# costs host CPU DURING the measured steady state
_seen: set = set()
_seen_lock = threading.Lock()

_enabled_cache: bool | None = None


def enabled() -> bool:
    global _enabled_cache
    env = os.environ.get("CMSBWT_PREWARM", "").strip()
    if env == "0":
        return False
    if env == "1":
        return True
    if _enabled_cache is None:
        try:
            import jax
            _enabled_cache = any(d.platform != "cpu" for d in jax.devices())
        except Exception:
            _enabled_cache = False
    return _enabled_cache


def sds(shape, dtype):
    import jax
    return jax.ShapeDtypeStruct(shape, dtype)


class Wave:
    """A batch of background AOT compiles keyed by name.

    Daemon threads (not a ThreadPoolExecutor): an abandoned compile must
    never block interpreter exit — bench children exit right after their
    run, and atexit joins non-daemon pool threads."""

    def __init__(self):
        self._done: dict[str, threading.Event] = {}

    def add(self, name: str, fn, *avals, x64: bool = False,
            **statics) -> None:
        """``x64=True`` lowers under jax.enable_x64: without it an int64
        ShapeDtypeStruct is canonicalized to int32 during lowering while a
        CONCRETE int64 array keeps int64 at dispatch — the AOT compile
        would silently produce a program the dispatch never matches (the
        r04 cold run compiled tail_good twice at ~100 s each this way)."""
        if not enabled():
            return
        key = (id(fn), repr(avals), tuple(sorted(statics.items())), x64)
        with _seen_lock:
            if key in _seen:
                return
            _seen.add(key)
        ev = threading.Event()
        self._done[name] = ev

        def work():
            try:
                import jax
                if x64:
                    with jax.enable_x64(True):
                        fn.lower(*avals, **statics).compile()
                else:
                    fn.lower(*avals, **statics).compile()
            except Exception:
                pass  # best-effort; dispatch will compile on miss
            finally:
                ev.set()

        threading.Thread(target=work, daemon=True,
                         name=f"cmsbwt-prewarm-{name}").start()

    def ready(self, name: str) -> None:
        """Block until ``name``'s compile finished (no-op if never added)."""
        ev = self._done.pop(name, None)
        if ev is not None:
            ev.wait(timeout=_MAX_WAIT_S)

    def ready_all(self) -> None:
        for name in list(self._done):
            self.ready(name)
