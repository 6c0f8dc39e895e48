"""Sharded reference index: prefix-doubling suffix sort over a device mesh
with int64 global indices — the >2^31 design of docs/giant_references.md
made executable (scaled down; validated on the virtual CPU mesh).

The reference binary caps the reference at 2^31 chars (int32 libsais SA,
ref ``CMS-BWT-functions.cpp:246``, ``CMS-BWT.h:44``). Lifting the cap
on devices means the index itself is sharded over a ``Mesh(('ref',))``:
no array ever materializes n contiguous int64 elements on one device.

Per doubling round, entirely inside one ``shard_map`` program:

* ``rank[i + w]`` — the only non-local read of the round — is TWO
  ``ppermute`` shard rotations plus a local splice (``_shift_sharded``):
  with ``w = q*local + r`` every element's source lies in shard ``s+q``
  or ``s+q+1``.  This is the halo exchange of the design doc generalized
  to any ``w`` (the doc's "first w ranks of the right neighbor" is the
  ``q=0`` case).
* the global key sort is a padded-bucket **sample sort**: local sort,
  regularly-sampled splitters (all_gather), searchsorted partition, one
  ``all_to_all`` with per-destination capacity ``local`` (a shard never
  owns more than ``local`` elements, so no bucket can exceed it), local
  re-sort.  Shard loads are irregular mid-round; ranks are written back
  to the regular layout by a second all_to_all routed on ``idx // local``.
* global rank assignment is a local cumsum plus an exclusive scan over
  the shards' change-counts (all_gather of one scalar per shard) — the
  distributed form of the ``cumsum(changed) - 1`` in
  ``index/device.py:_dense_rank``.

Rounds QUADRUPLE: keys are (rank, rank[i+w], rank[i+2w], rank[i+3w])
int64 rows sorted with ``num_keys=4`` — two doubling levels per sample
sort, so the build pays half the full-width rounds — and no packing in
the keys, so ranks up to 2^62 are representable (the int32 paths pack
two ranks into one int64 and stop at 2^31). Rounds stop early once all
ranks are distinct.

This module is the executable prototype for the large-reference regime:
correct at any n that fits the mesh's aggregate memory, exercised in CI
at dryrun scale (tests/test_sharded_index.py) on 8 virtual CPU devices
against the single-device sort and a numpy oracle.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .dist import _bucket_offsets

AXIS = "ref"


def make_ref_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _axis_index():
    return jax.lax.axis_index(AXIS)


def _shift_sharded(vals: jnp.ndarray, w: jnp.ndarray, n: jnp.ndarray,
                   local: int, n_shards: int, pad_val) -> jnp.ndarray:
    """Global ``out[i] = vals[i + w]`` (pad past n) on (local,)-sharded rows.

    w = q*local + r: element i of shard s reads shard s+q (positions >= r)
    or shard s+q+1 (positions < r). Two whole-shard ppermutes + splice.
    """
    q = w // local
    r = w - q * local
    s = _axis_index()

    def rot(block, steps):
        # bring shard (s + steps) % n_shards's block to shard s
        perm = [(src, (src - steps) % n_shards) for src in range(n_shards)]
        return jax.lax.ppermute(block, AXIS, perm)

    # dynamic q: rotate by q via log-steps (q < n_shards)
    def rot_dyn(block, steps):
        out = block
        for bit in range(max(1, n_shards.bit_length())):
            amt = 1 << bit
            rotated = rot(out, amt)
            out = jnp.where((steps & amt) != 0, rotated, out)
        return out

    a = rot_dyn(vals, q)          # shard s+q's block
    b = rot(a, 1)                 # shard s+q+1's block
    idx = jnp.arange(local, dtype=jnp.int64)
    spliced = jnp.where(idx + r < local,
                        a[jnp.minimum(idx + r, local - 1)],
                        b[jnp.clip(idx + r - local, 0, local - 1)])
    gi = s.astype(jnp.int64) * local + idx + w
    return jnp.where(gi < n, spliced, pad_val)


def _exclusive_shard_prefix(count: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Exclusive prefix of a per-shard scalar across the mesh axis."""
    all_counts = jax.lax.all_gather(count, AXIS)          # (R,)
    s = _axis_index()
    mask = jnp.arange(n_shards) < s
    return jnp.sum(jnp.where(mask, all_counts, 0))


def _sample_sort(keys, v, local: int, n_shards: int, kmax):
    """Globally sort rows by the key list (lexicographic) across the mesh
    axis, carrying payload ``v``.

    Returns (keys_sorted, v, valid) in padded irregular layout: each shard
    holds a sorted slice of the global order, ``valid`` rows of it real.
    No overflow is possible: a source holds ``local`` rows total, so no
    per-(source, destination) bucket can exceed the ``local`` capacity of
    the padded-bucket all_to_all grid.
    """
    nk = len(keys)
    ops = jax.lax.sort((*keys, v), num_keys=nk)
    ks_s, vs = list(ops[:nk]), ops[nk]

    # regular sampling: n_shards candidates per shard
    step = max(local // n_shards, 1)
    cand_idx = jnp.minimum(jnp.arange(n_shards) * step, local - 1)
    gs = [jax.lax.all_gather(k[cand_idx], AXIS, tiled=True)  # (R*R,)
          for k in ks_s]
    gs = list(jax.lax.sort(tuple(gs), num_keys=nk))
    spl_idx = jnp.arange(1, n_shards) * n_shards
    spl = [g[spl_idx] for g in gs]                        # (R-1,) splitters

    # destination shard per row: count of splitters <= row (lexicographic)
    eq = jnp.ones((local, n_shards - 1), bool)
    below = jnp.zeros((local, n_shards - 1), bool)
    for sk, rk in zip(spl, ks_s):
        below = below | (eq & (sk[None, :] < rk[:, None]))
        eq = eq & (sk[None, :] == rk[:, None])
    below = below | eq
    dest = jnp.sum(below.astype(jnp.int32), axis=1)        # (local,) in [0,R)

    # pack rows into per-destination buckets of capacity local
    # rows are sorted, so dest is non-decreasing: bucket-local offset =
    # position - first position of that dest
    first = jnp.searchsorted(dest, jnp.arange(n_shards), side="left")
    offs = jnp.arange(local) - first[dest]

    def exch(arr, fill):
        send = jnp.full((n_shards, local), fill, arr.dtype)
        send = send.at[dest, offs].set(arr)
        return jax.lax.all_to_all(send, AXIS, 0, 0, tiled=False).reshape(-1)

    rk = [exch(k, kmax) for k in ks_s]
    rv = exch(vs, jnp.zeros((), vs.dtype))
    m = jax.lax.sort((*rk, rv), num_keys=nk)
    mk, mv = list(m[:nk]), m[nk]
    valid = jnp.sum((mk[0] < kmax).astype(jnp.int64))
    return mk, mv, valid


def _scatter_back(idx, val, local: int, n_shards: int, valid):
    """Route (idx, val) rows (idx = global position, irregular padded
    layout of size n_shards*local) back to the regular layout: shard
    idx // local, slot idx % local. Second padded all_to_all."""
    rows = idx.shape[0]
    live = jnp.arange(rows, dtype=jnp.int64) < valid
    dest = jnp.where(live, idx // local, n_shards)         # n_shards = drop
    slot = jnp.where(live, idx - dest * local, 0)
    sendv = jnp.zeros((n_shards, local), val.dtype)
    # rows with equal dest write distinct slots (idx unique) — no collision
    sendv = sendv.at[dest, slot].set(val, mode="drop")
    sent = jnp.zeros((n_shards, local), jnp.int32)
    sent = sent.at[dest, slot].set(1, mode="drop")
    rv = jax.lax.all_to_all(sendv, AXIS, 0, 0, tiled=False)
    rs = jax.lax.all_to_all(sent, AXIS, 0, 0, tiled=False)
    # each (shard, slot) receives exactly one live row across sources
    out = jnp.sum(rv * rs.astype(rv.dtype), axis=0)
    return out


def sharded_suffix_array(x: np.ndarray, n_devices: int | None = None):
    """Suffix array of ``x`` (uint8, unique terminator recommended) computed
    shard-parallel with int64 global indices. Returns (sa, isa) int64[n].

    Scaled-down executable form of docs/giant_references.md; the same
    program shape runs with local shards < 2^31 at any global n."""
    mesh = make_ref_mesh(n_devices)
    n_shards = mesh.devices.size
    n = int(len(x))
    local = -(-n // n_shards)
    # pad to R*local with 0 (masked off by in_n inside the program)
    x_pad = np.zeros(n_shards * local, np.uint8)
    x_pad[:n] = x
    rounds = 1
    while (1 << rounds) < max(n, 2):
        rounds += 1
    xd = jax.device_put(
        jnp.asarray(x_pad.astype(np.int32)),
        NamedSharding(mesh, P(AXIS)))
    with jax.enable_x64(True):
        rank, sa, _hist = _sharded_sa_history_program(
            mesh, xd, jnp.asarray([n], jnp.int64), local, n_shards, rounds)
    sa_np = np.asarray(sa)[:n]
    isa_np = np.asarray(rank)[:n]
    return sa_np.astype(np.int64), isa_np.astype(np.int64)


def _gather_sharded(vals: jnp.ndarray, q: jnp.ndarray, local: int,
                    n_shards: int, oob_val) -> jnp.ndarray:
    """General cross-shard gather: out[j] = global_vals[q[j]] for arbitrary
    int64 global indices (out-of-range -> oob_val).

    Two padded all_to_alls: queries route to their owner shard (dest =
    q // local), owners answer with a local gather, and the SAME buffer
    layout carries answers back (all_to_all is its own inverse on the
    (n_shards, local) bucket grid). Per-(source, owner) bucket capacity is
    ``local`` — trivially sufficient since a source has only ``local``
    queries in total. This is the routed-gather fallback of
    docs/giant_references.md item 2 (lift walks that cross shards).
    """
    n_total = local * n_shards
    inr = (q >= 0) & (q < n_total)
    qc = jnp.clip(q, 0, n_total - 1)
    dest = (qc // local).astype(jnp.int32)
    # bucket-local offsets: rank of each query within its dest group
    offs = _bucket_offsets(dest, n_shards)
    sendq = jnp.zeros((n_shards, local), jnp.int64)
    sendq = sendq.at[dest, offs].set(qc - dest.astype(jnp.int64) * local)
    recvq = jax.lax.all_to_all(sendq, AXIS, 0, 0, tiled=False)
    ans = vals[jnp.clip(recvq, 0, local - 1)]
    back = jax.lax.all_to_all(ans, AXIS, 0, 0, tiled=False)
    res = back[dest, offs]
    return jnp.where(inr, res, oob_val)


def _shift_right_one(vals: jnp.ndarray, n_shards: int, pad_val):
    """Global out[i] = vals[i-1] (out[0] = pad_val) on sharded rows."""
    s = _axis_index()
    last = vals[-1]
    perm = [(src, src + 1) for src in range(n_shards - 1)]
    from_left = jax.lax.ppermute(last, AXIS, perm)
    shifted = jnp.concatenate([from_left[None], vals[:-1]])
    return jnp.where((s == 0) & (jnp.arange(vals.shape[0]) == 0),
                     pad_val, shifted)


@functools.partial(jax.jit, static_argnames=("mesh", "local", "n_shards",
                                             "rounds"))
def _sharded_lcp_program(mesh, hist_sh, sa_sh, n, local: int,
                         n_shards: int, rounds: int):
    def body(hist, sa, n):
        n = n[0]
        s = _axis_index()
        gidx = s.astype(jnp.int64) * local + \
            jnp.arange(local, dtype=jnp.int64)
        in_n = (gidx < n) & (gidx >= 1)
        a = _shift_right_one(sa, n_shards, jnp.int64(-1))   # SA[i-1]
        b = sa
        # pcast to varying: the carry becomes device-varying on the first
        # collective, so it must START varying for scan's type check
        # (shard_map vma)
        h = jax.lax.pcast(jnp.zeros(local, jnp.int64), AXIS, to="varying")

        def level(h, k):
            rk = hist[k]
            va = a + h
            vb = b + h
            ok = in_n & (va < n) & (vb < n) & (a >= 0)
            ga = _gather_sharded(rk, jnp.where(ok, va, 0), local,
                                 n_shards, jnp.int64(-1))
            gb = _gather_sharded(rk, jnp.where(ok, vb, 0), local,
                                 n_shards, jnp.int64(-2))
            eq = ok & (ga == gb)
            return h + jnp.where(eq, jnp.int64(1) << k, 0), None

        h, _ = jax.lax.scan(level, h,
                            jnp.arange(rounds, -1, -1, dtype=jnp.int64))
        return jnp.where(in_n, h, 0)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS), P()),
        out_specs=P(AXIS))(hist_sh, sa_sh, n)


def sharded_suffix_array_with_lcp(x: np.ndarray,
                                  n_devices: int | None = None):
    """(sa, isa, lcp) with int64 global indices, all computed shard-
    parallel: the doubling sort keeps its per-round rank history sharded,
    and the LCP lift runs binary-lifting equality walks whose cross-shard
    reads go through the routed gather (_gather_sharded).

    LCP layout matches index/device.lcp_device: int64[n+1], LCP[0] = 0,
    LCP[n] = -1."""
    mesh = make_ref_mesh(n_devices)
    n_shards = mesh.devices.size
    n = int(len(x))
    local = -(-n // n_shards)
    x_pad = np.zeros(n_shards * local, np.uint8)
    x_pad[:n] = x
    rounds = 1
    while (1 << rounds) < max(n, 2):
        rounds += 1
    xd = jax.device_put(jnp.asarray(x_pad.astype(np.int32)),
                        NamedSharding(mesh, P(AXIS)))
    with jax.enable_x64(True):
        rank, sa, hist = _sharded_sa_history_program(
            mesh, xd, jnp.asarray([n], jnp.int64), local, n_shards, rounds)
        lcp = _sharded_lcp_program(mesh, hist, sa,
                                   jnp.asarray([n], jnp.int64),
                                   local, n_shards, rounds)
    sa_np = np.asarray(sa)[:n].astype(np.int64)
    isa_np = np.asarray(rank)[:n].astype(np.int64)
    lcp_np = np.concatenate([np.asarray(lcp)[:n], [-1]]).astype(np.int64)
    lcp_np[0] = 0
    return sa_np, isa_np, lcp_np


@functools.partial(jax.jit, static_argnames=("mesh", "local", "n_shards",
                                             "rounds"))
def _sharded_sa_history_program(mesh, x_sh, n, local: int, n_shards: int,
                                rounds: int):
    """Sharded doubling sort + per-level rank history (level k = ranks of
    2^k-windows, the LCP lift's comparison rows).

    QUADRUPLING rounds: each sample sort refines by
    TWO window-doubling levels at once — keys (rank, rank@+w, rank@+2w,
    rank@+3w) — so the round count (and with it the full-width sorts and
    exchanges, the build's cost) halves. Both refined granularities are
    recovered from the one sorted order, so the history still has every
    level. Rounds also stop early once ranks are all distinct."""
    kmax = jnp.int64(2**62)
    n_hist = rounds + 3
    # ranks are global group ids < R*local: when that bound fits 31 bits
    # the two granularities ride ONE packed scatter_back; the giant
    # (> 2^31) regime pays a second routed exchange instead
    can_pack = local * n_shards < (1 << 31)

    def body(x_local, n):
        n = n[0]
        s = _axis_index()
        gidx = s.astype(jnp.int64) * local + \
            jnp.arange(local, dtype=jnp.int64)
        in_n = gidx < n
        rank = jnp.where(in_n, x_local.astype(jnp.int64), kmax)
        hist = jnp.zeros((n_hist, local), jnp.int64).at[0].set(rank)
        rows_n = n_shards * local
        ri = jnp.arange(rows_n, dtype=jnp.int64)

        def round_w(carry, k):
            rank, hist, done = carry
            w = jnp.int64(1) << k

            def do(rank):
                sh = lambda off: _shift_sharded(rank, off, n, local,
                                                n_shards, jnp.int64(-1))
                keys = [jnp.where(in_n, rank, kmax),
                        jnp.where(in_n, sh(w), jnp.int64(-1)),
                        jnp.where(in_n, sh(2 * w), jnp.int64(-1)),
                        jnp.where(in_n, sh(3 * w), jnp.int64(-1))]
                mk, mi, valid = _sample_sort(keys, gidx, local, n_shards,
                                             kmax)
                live = ri < valid
                prevs = [jnp.roll(x, 1) for x in mk]
                eq12 = (mk[0] == prevs[0]) & (mk[1] == prevs[1])
                eq_full = eq12 & (mk[2] == prevs[2]) & (mk[3] == prevs[3])
                changed_m = live & ~(eq12 & (ri > 0))
                changed_f = live & ~(eq_full & (ri > 0))
                # cross-shard tie continuation (both granularities): if my
                # first live key equals the last live key of the nearest
                # non-empty shard to the left, row 0 continues that group
                has = valid > 0
                last_i = jnp.maximum(valid - 1, 0)
                g_has = jax.lax.all_gather(has, AXIS)
                g_last = [jax.lax.all_gather(x[last_i], AXIS) for x in mk]
                t = jnp.arange(n_shards)
                j = jnp.max(jnp.where((t < s) & g_has, t, -1))
                jc = jnp.maximum(j, 0)
                same12 = (j >= 0) & (mk[0][0] == g_last[0][jc]) & \
                    (mk[1][0] == g_last[1][jc])
                same_f = same12 & (mk[2][0] == g_last[2][jc]) & \
                    (mk[3][0] == g_last[3][jc])
                changed_m = changed_m.at[0].set(live[0] & ~same12)
                changed_f = changed_f.at[0].set(live[0] & ~same_f)

                def ranks_of(changed):
                    lm = jnp.cumsum(changed.astype(jnp.int64))
                    prefix = _exclusive_shard_prefix(lm[-1], n_shards)
                    return prefix + lm - 1

                gr_m = ranks_of(changed_m)
                gr_f = ranks_of(changed_f)
                if can_pack:
                    packed = (gr_m << 31) | gr_f
                    np_ = _scatter_back(mi, packed, local, n_shards, valid)
                    mid = np_ >> 31
                    full = np_ & ((jnp.int64(1) << 31) - 1)
                else:
                    mid = _scatter_back(mi, gr_m, local, n_shards, valid)
                    full = _scatter_back(mi, gr_f, local, n_shards, valid)
                return (jnp.where(in_n, mid, kmax),
                        jnp.where(in_n, full, kmax))

            mid_rank, full_rank = jax.lax.cond(
                done, lambda r: (r, r), do, rank)
            hist = jax.lax.dynamic_update_slice(
                hist, mid_rank[None], (k + 1, 0))
            hist = jax.lax.dynamic_update_slice(
                hist, full_rank[None], (k + 2, 0))
            nmax = jax.lax.pmax(
                jnp.max(jnp.where(in_n, full_rank, -1)), AXIS)
            done = done | (nmax == n - 1)
            return (full_rank, hist, done), None

        ks = jnp.arange(0, rounds, 2, dtype=jnp.int64)
        (rank, hist, _), _ = jax.lax.scan(
            round_w, (rank, hist, jnp.bool_(False)), ks)
        rows = rank.shape[0]
        sa = _scatter_back(jnp.where(in_n, rank, rows * n_shards + gidx),
                           gidx, local, n_shards, jnp.int64(local))
        return rank, sa, hist

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(None, AXIS)))(x_sh, n)


def build_sharded_reference_index(x_aug: np.ndarray,
                                  n_devices: int | None = None):
    """Full ``ReferenceIndex`` built by the sharded int64 pipeline — the
    giant-reference route of ``engine/pipeline.compute_bwt``
    (docs/giant_references.md item 4; lifts the reference tool's int32 cap,
    ref ``CMS-BWT-functions.cpp:246``).

    SA/ISA/LCP come from the shard-parallel doubling sort + LCP lift; the
    PLCP skip bound and reference BWT are the same O(n) maps the host
    builder uses (ref ``:272-274`` and ``:294-297``), computed on int64
    indices. The downstream host engine (scan/merge) is dtype-agnostic and
    ``engine/tails.py`` switches to two-key comparisons above the packing
    bound, so the whole pipeline stays exact at any n the aggregate memory
    of the mesh (and this host view) can hold."""
    from ..index.host import ReferenceIndex, plcp_skip_bound
    sa, isa, lcp = sharded_suffix_array_with_lcp(x_aug, n_devices=n_devices)
    plcp = plcp_skip_bound(lcp, isa)
    bwt = np.where(sa > 0, x_aug[np.maximum(sa - 1, 0)],
                   np.uint8(0)).astype(np.uint8)
    x_padded = np.concatenate([x_aug, np.zeros(1, np.uint8)])
    return ReferenceIndex(x=x_aug, x_padded=x_padded, n=len(x_aug),
                          sa=sa, isa=isa, lcp=lcp, plcp=plcp, bwt=bwt,
                          rank_history=[])
