"""Distributed primitive oracles (parallel/dist.py) on the virtual
8-device CPU mesh."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cmsbwt_tpu.parallel import dist as D

R = 8
LOCAL = 64
G = R * LOCAL
KMAX = 1 << 62


def _mesh():
    return D.make_mesh(R)


def _run(fn, *arrs):
    """shard_map a local-view function over regular-layout inputs."""
    mesh = _mesh()
    sharded = [D.shard(mesh, a, 0, LOCAL) for a in arrs]
    out = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(P(D.AXIS) for _ in sharded),
        out_specs=P(D.AXIS)))(*sharded)
    return np.asarray(out)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def test_dcumsum_and_rev():
    rng = np.random.default_rng(0)
    v = rng.integers(-5, 9, G).astype(np.int64)
    got = _run(lambda x: D.dcumsum(x, R), v)
    np.testing.assert_array_equal(got, np.cumsum(v))
    got = _run(lambda x: D.dcumsum_rev(x, R), v)
    np.testing.assert_array_equal(got, np.cumsum(v[::-1])[::-1])


def test_dcummax_and_min_rev():
    rng = np.random.default_rng(1)
    v = rng.integers(-100, 100, G).astype(np.int64)
    np.testing.assert_array_equal(
        _run(lambda x: D.dcummax(x, R), v), np.maximum.accumulate(v))
    np.testing.assert_array_equal(
        _run(lambda x: D.dcummin_rev(x, R), v),
        np.minimum.accumulate(v[::-1])[::-1])
    np.testing.assert_array_equal(
        _run(lambda x: D.dcummax_rev(x, R), v),
        np.maximum.accumulate(v[::-1])[::-1])


@pytest.mark.parametrize("w", [0, 1, -1, 5, -7, 63, 64, 65, -64, 300, -300,
                               G - 1, -(G - 1)])
def test_dshift(w):
    rng = np.random.default_rng(2)
    v = rng.integers(0, 1000, G).astype(np.int64)
    got = _run(lambda x: D.dshift(x, jnp.int64(w), jnp.int64(-9),
                                  LOCAL, R), v)
    idx = np.arange(G) + w
    exp = np.where((idx >= 0) & (idx < G), v[np.clip(idx, 0, G - 1)], -9)
    np.testing.assert_array_equal(got, exp)


def test_dgather():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 1000, G).astype(np.int64)
    q = rng.integers(-10, G + 10, G).astype(np.int64)
    got = _run(lambda a, b: D.dgather(a, b, jnp.int64(-1), LOCAL, R), v, q)
    exp = np.where((q >= 0) & (q < G), v[np.clip(q, 0, G - 1)], -1)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("mode", ["set", "add", "max"])
def test_dscatter(mode):
    rng = np.random.default_rng(4)
    base = rng.integers(0, 50, G).astype(np.int64)
    val = rng.integers(1, 100, G).astype(np.int64)
    if mode == "set":
        idx = rng.permutation(G + 40)[:G].astype(np.int64) - 20
    else:
        idx = rng.integers(-20, G + 20, G).astype(np.int64)
    got = _run(lambda b, i, x: D.dscatter(b, i, x, LOCAL, R, mode),
               base, idx, val)
    exp = base.copy()
    for i, x in zip(idx, val):
        if 0 <= i < G:
            if mode == "set":
                exp[i] = x
            elif mode == "add":
                exp[i] += x
            else:
                exp[i] = max(exp[i], x)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("seed,dup", [(0, 1), (1, 4), (2, 1000)])
def test_dsort_two_keys(seed, dup):
    rng = np.random.default_rng(seed)
    nv = G - rng.integers(0, G // 2)
    k0 = rng.integers(0, max(G // dup, 2), G).astype(np.int64)
    k1 = rng.integers(0, 5, G).astype(np.int64)
    pay = rng.integers(0, 10**6, G).astype(np.int64)
    k0[nv:] = KMAX

    def f(a, b, c):
        ks, ps = D.dsort([a, b], [c], LOCAL, R, jnp.int64(KMAX))
        return jnp.stack([ks[0], ks[1], ps[0]])

    mesh = _mesh()
    outs = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(D.AXIS),) * 3,
        out_specs=P(None, D.AXIS)))(
        D.shard(mesh, k0, 0, LOCAL), D.shard(mesh, k1, 0, LOCAL),
        D.shard(mesh, pay, 0, LOCAL))
    g0, g1, gp = (np.asarray(outs[i]) for i in range(3))
    order = np.lexsort((pay[:nv], k1[:nv], k0[:nv]))
    np.testing.assert_array_equal(g0[:nv], k0[:nv][order])
    np.testing.assert_array_equal(g1[:nv], k1[:nv][order])
    # payload rows must be the exact multiset per (k0, k1) group; with the
    # payload as a tiebreaker in the local sorts the order is total
    np.testing.assert_array_equal(
        np.sort(gp[:nv]), np.sort(pay[:nv]))
    assert (g0[nv:] == KMAX).all()


@pytest.mark.parametrize("n_shards, rows", [(4, 37), (8, 200), (3, 1)])
def test_bucket_offsets_matches_rank_within_group(n_shards, rows):
    """Offset of each row within its destination bucket, in row order;
    rows bound for the drop bucket (dest == n_shards) get offset 0. Runs
    under x64, the width of the mesh exchanges."""
    rng = np.random.default_rng(n_shards * 1000 + rows)
    dest = rng.integers(0, n_shards + 1, rows).astype(np.int32)
    want = np.zeros(rows, np.int64)
    seen = {}
    for i, d in enumerate(dest):
        if d < n_shards:
            want[i] = seen.get(d, 0)
            seen[d] = want[i] + 1
    with jax.enable_x64(True):
        got = jax.jit(D._bucket_offsets, static_argnums=1)(
            jnp.asarray(dest), n_shards)
        np.testing.assert_array_equal(np.asarray(got), want)
