"""Device (JAX/XLA) reference-index construction — the libsais replacement
(SURVEY.md §7.2).

Everything is jit-compiled with static shapes:

* suffix array: Manber–Myers prefix doubling; each round is one
  ``jax.lax.sort`` over (rank, rank[i+k]) key pairs; converged rounds are
  skipped with ``lax.cond``.
* rank history: kept in a [LEVELS, n] int32 buffer; LCP is computed by
  binary-lifting window-rank comparisons over that history (no sequential
  Kasai dependency — fully parallel across SA-adjacent pairs).
* PSV/NSV: a power-of-two sparse table of LCP window minima; queries are
  O(log n) gathers (replaces the pointer-chasing rmq_tree, ref rmq_tree.h).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def _dense_rank(vals: jnp.ndarray) -> jnp.ndarray:
    """Dense rank (ties share rank) of an int array — sort-based, no
    scatter."""
    n = vals.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    sv, order = jax.lax.sort((vals, idx), num_keys=1)
    changed = jnp.concatenate([jnp.ones(1, jnp.int32),
                               (sv[1:] != sv[:-1]).astype(jnp.int32)])
    ranks_sorted = (jnp.cumsum(changed) - 1).astype(jnp.int32)
    _, rank = jax.lax.sort((order, ranks_sorted), num_keys=1)
    return rank


def n_levels(n: int) -> int:
    """Doubling levels: level k covers windows of 2**k; we need 2**k >= n."""
    lv = 1
    while (1 << lv) < n:
        lv += 1
    return lv + 1  # include level 0


@functools.partial(jax.jit, static_argnames=("n",))
def suffix_array_device(x: jnp.ndarray, n: int
                        ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Return (sa int32[n], isa int32[n], history int32[LEVELS, n]).

    Each doubling round is two lax.sorts: one by (rank, rank[i+k]) and one
    to invert the resulting permutation. Sorts replace all O(n) random
    scatters (whether a direct scatter is cheaper on the GPU awaits
    measurement).
    """
    levels = n_levels(n)
    idx = jnp.arange(n, dtype=jnp.int32)

    # Seed ranks for windows of 1 and 2 without full sort rounds: dense char
    # ranks, then packed pair ranks (char ranks are < n so a 2^31-safe pack
    # needs the dense remap first).
    rank0 = _dense_rank(x.astype(jnp.int32))
    history = jnp.zeros((levels, n), jnp.int32).at[0].set(rank0)

    def shifted(rank, shift):
        padded = jnp.concatenate([rank, jnp.full(n, -1, jnp.int32)])
        return jax.lax.dynamic_slice(padded, (shift,), (n,))

    with jax.enable_x64(True):
        pair = (rank0.astype(jnp.int64) << 32) | \
            (shifted(rank0, jnp.int32(1)).astype(jnp.int64) + 1)
        rank1 = _dense_rank(pair)
    history = history.at[1].set(rank1)

    def round_k(carry, k):
        rank, sa, history, done, k_star = carry
        shift = jnp.int32(1) << k

        def do_sort(args):
            rank, sa = args
            nxt = shifted(rank, shift)
            with jax.enable_x64(True):
                # one packed int64 key instead of two int32 keys
                key = (rank.astype(jnp.int64) << 32) | \
                    (nxt.astype(jnp.int64) + 1)
                k_s, ord_s = jax.lax.sort((key, idx), num_keys=1)
                changed = jnp.concatenate(
                    [jnp.ones(1, jnp.int32),
                     (k_s[1:] != k_s[:-1]).astype(jnp.int32)])
            new_sorted = jnp.cumsum(changed).astype(jnp.int32) - 1
            # invert the permutation by sorting (ord_s, new_sorted)
            _, new_rank = jax.lax.sort((ord_s, new_sorted), num_keys=1)
            return new_rank, ord_s

        new_rank, sa = jax.lax.cond(done, lambda a: a, do_sort, (rank, sa))
        history = history.at[k + 1].set(
            jnp.where(done, history[k], new_rank))
        now_done = jnp.max(new_rank) == n - 1
        # k_star = first level with fully distinct ranks; lifts only need
        # levels < k_star (max lcp < 2^k_star)
        k_star = jnp.where(done, k_star,
                           jnp.where(now_done, k + 1, k_star))
        done = done | now_done
        return (new_rank, sa, history, done, k_star), None

    done1 = jnp.max(rank1) == n - 1
    sa1 = jnp.zeros(n, jnp.int32)
    k_star0 = jnp.where(done1, 1, levels).astype(jnp.int32)
    (rank, sa, history, done, k_star), _ = jax.lax.scan(
        round_k, (rank1, sa1, history, done1, k_star0),
        jnp.arange(1, levels - 1, dtype=jnp.int32))
    # if no round ran (tiny/converged input), invert rank explicitly
    def invert(_):
        _, s = jax.lax.sort((rank, idx), num_keys=1)
        return s
    sa = jax.lax.cond(done1, invert, lambda a: a, sa)
    return sa, rank, history, k_star


@functools.partial(jax.jit, static_argnames=("n",))
def lcp_device(sa: jnp.ndarray, history: jnp.ndarray, n: int) -> jnp.ndarray:
    """LCP int32[n+1]: LCP[i] = lcp(SA[i-1], SA[i]), LCP[0]=0, LCP[n]=-1."""
    levels = history.shape[0]
    a = sa[:-1].astype(jnp.int32)
    b = sa[1:].astype(jnp.int32)
    h = jnp.zeros(n - 1, jnp.int32)

    def level(h, k):
        rk = history[k]
        va = a + h
        vb = b + h
        ok = (va < n) & (vb < n)
        eq = ok & (rk[jnp.minimum(va, n - 1)] == rk[jnp.minimum(vb, n - 1)])
        return h + jnp.where(eq, jnp.int32(1) << k, 0), None

    h, _ = jax.lax.scan(level, h,
                        jnp.arange(levels - 1, -1, -1, dtype=jnp.int32))
    lcp = jnp.concatenate([jnp.zeros(1, jnp.int32), h,
                           jnp.full(1, -1, jnp.int32)])
    return lcp


def sparse_table_levels(n: int) -> int:
    lv = 1
    while (1 << lv) <= n:
        lv += 1
    return lv


@functools.partial(jax.jit, static_argnames=("n",))
def build_lcp_sparse_table(lcp: jnp.ndarray, n: int) -> jnp.ndarray:
    """jump[k][i] = min(LCP[i .. i+2^k)), padded with INF past n.

    Replaces rmq_tree (ref rmq_tree.h:48-59) for PSV/NSV queries.
    """
    INF = jnp.int32(2**31 - 1)
    levels = sparse_table_levels(n)
    base = jnp.where(jnp.arange(n) < n, lcp[:n], INF)
    jump = jnp.zeros((levels, n), jnp.int32).at[0].set(base)

    def level(jump, k):
        half = jnp.int32(1) << (k - 1)
        prev = jump[k - 1]
        idx = jnp.arange(n, dtype=jnp.int32)
        other = jnp.where(idx + half < n,
                          prev[jnp.minimum(idx + half, n - 1)], INF)
        return jump.at[k].set(jnp.minimum(prev, other)), None

    jump, _ = jax.lax.scan(level, jump,
                           jnp.arange(1, levels, dtype=jnp.int32))
    return jump


def psv_device(jump: jnp.ndarray, i: jnp.ndarray, ub: jnp.ndarray,
               n: int) -> jnp.ndarray:
    """Vector PSV: largest j <= i with LCP[j] < ub, else -1
    (rmq_tree.h:184-205 semantics — the scan includes i itself)."""
    levels = jump.shape[0]
    d = jnp.zeros_like(i)

    def level(d, k):
        w = jnp.int32(1) << k
        s = i - d - w + 1
        ok = s >= 0
        mins = jump[k][jnp.maximum(s, 0)]
        take = ok & (mins >= ub)
        return d + jnp.where(take, w, 0), None

    d, _ = jax.lax.scan(level, d,
                        jnp.arange(levels - 1, -1, -1, dtype=jnp.int32))
    res = i - d
    return jnp.where(res >= 0, res, -1)


def nsv_device(jump: jnp.ndarray, i: jnp.ndarray, ub: jnp.ndarray,
               n: int) -> jnp.ndarray:
    """Vector NSV: smallest j >= i (j < n) with LCP[j] < ub, else -1."""
    levels = jump.shape[0]
    d = jnp.zeros_like(i)

    def level(d, k):
        w = jnp.int32(1) << k
        s = i + d
        ok = s + w <= n
        mins = jump[k][jnp.minimum(s, n - 1)]
        take = ok & (mins >= ub)
        return d + jnp.where(take, w, 0), None

    d, _ = jax.lax.scan(level, d,
                        jnp.arange(levels - 1, -1, -1, dtype=jnp.int32))
    res = i + d
    return jnp.where(res < n, res, -1)


@dataclass
class DeviceIndex:
    """Reference index resident on device (int32 throughout; n < 2^31)."""

    x_padded: jnp.ndarray    # uint8 [n + PAD] (x_padded[n] = 0, rest 0xFF)
    n: int
    sa: jnp.ndarray          # int32 [n]
    isa: jnp.ndarray         # int32 [n]
    lcp: jnp.ndarray         # int32 [n+1]
    plcp: jnp.ndarray        # int32 [n]
    bwt: jnp.ndarray         # uint8 [n]
    jump: jnp.ndarray        # int32 [levels, n] sparse-table minima

    PAD = 1024  # text overrun pad for windowed compares (mismatching bytes)


@functools.partial(jax.jit, static_argnames=("n",))
def _index_tail(x, sa, isa, lcp, n: int):
    """PLCP skip bound, reference BWT, sparse table, padded text — one
    compiled program (eager jnp ops with Python-scalar operands would
    transfer implicitly; see utils/xfer.py)."""
    plcp = jnp.maximum(lcp[isa], lcp[jnp.minimum(isa + 1, n)])
    bwt = jnp.where(sa > 0, x[jnp.maximum(sa - 1, 0)], jnp.uint8(0))
    jump = build_lcp_sparse_table(lcp, n)
    pad = jnp.full(DeviceIndex.PAD, 255, jnp.uint8).at[0].set(0)
    x_padded = jnp.concatenate([x, pad])
    return plcp.astype(jnp.int32), bwt, jump, x_padded


def build_device_index(x_aug: np.ndarray) -> DeviceIndex:
    n = len(x_aug)
    x = jax.device_put(np.asarray(x_aug))
    sa, isa, history, _ = suffix_array_device(x, n)
    lcp = lcp_device(sa, history, n)
    plcp, bwt, jump, x_padded = _index_tail(x, sa, isa, lcp, n)
    return DeviceIndex(x_padded=x_padded, n=n, sa=sa, isa=isa, lcp=lcp,
                       plcp=plcp, bwt=bwt, jump=jump)


def build_reference_index_device(x_aug: np.ndarray):
    """Device-built index exported to the host ReferenceIndex container."""
    from .host import ReferenceIndex
    d = build_device_index(x_aug)
    n = d.n
    lcp = np.asarray(d.lcp)
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=n,
        sa=np.asarray(d.sa),
        isa=np.asarray(d.isa),
        lcp=lcp,
        plcp=np.asarray(d.plcp),
        bwt=np.asarray(d.bwt),
        rank_history=[],
    )
