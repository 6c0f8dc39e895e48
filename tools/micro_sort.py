"""Microbench of the primitive costs that bound the dense pipeline: sorts
with one and two keys, cumulative min/max and a permutation gather.

    python tools/micro_sort.py

Runs only on a GPU, and prints the card's name and power limit beside
the times (a card set below its maximum power runs slower)."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M = 22_200_000


def timeit(name, f, *args, reps=3):
    import jax
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
        jax.block_until_ready(out)
    print(f"{name}: {(time.perf_counter() - t0) / reps * 1e3:.1f} ms")


def main():
    from cmsbwt_tpu.utils.gpu import card_info, require_gpu
    devices = require_gpu()
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)   # the int64 keys stay int64
    print(f"# {devices[0].device_kind} x {len(devices)}: {card_info()}")
    rng = np.random.default_rng(0)
    k1 = jnp.asarray(rng.integers(0, 1 << 50, M, dtype=np.int64))
    k2 = jnp.asarray(rng.integers(0, 1 << 50, M, dtype=np.int64))
    k32 = jnp.asarray(rng.integers(0, 1 << 25, M, dtype=np.int32))
    idx = jnp.arange(M, dtype=jnp.int32)

    s1 = jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=1))
    s2 = jax.jit(lambda a, b, c: jax.lax.sort((a, b, c), num_keys=2))
    s2_32 = jax.jit(lambda a, b, c: jax.lax.sort((a, b, c), num_keys=2))
    s1_32 = jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=1))
    s4 = jax.jit(lambda a, b, c, d: jax.lax.sort((a, b, c, d), num_keys=1))
    cmx = jax.jit(lambda a: jax.lax.cummax(a))
    cmn64 = jax.jit(lambda a: jax.lax.cummin(a[::-1])[::-1])
    gth = jax.jit(lambda a, i: a[i])
    srt_perm = jnp.asarray(rng.permutation(M).astype(np.int32))

    timeit("sort 1key int64 + payload", s1, k1, idx)
    timeit("sort 1key int32 + payload", s1_32, k32, idx)
    timeit("sort 2key int64 + payload", s2, k1, k2, idx)
    timeit("sort 2key int32keys + payload", s2_32, k32, jnp.asarray(
        rng.integers(0, 1 << 25, M, dtype=np.int32)), idx)
    timeit("sort perm-key int32 + 3 payloads", s4, srt_perm, k32, k32, idx)
    timeit("cummax int32", cmx, k32)
    timeit("flip-cummin-flip int64", cmn64, k1)
    timeit("gather int32[M] by perm", gth, k32, srt_perm)


if __name__ == "__main__":
    main()
