"""Distributed-array primitives over a 1-D device mesh — the collective
vocabulary of the sharded downstream merge (parallel/sharded_merge.py).

Layout contract: a distributed array of global length G = R*local is a
jax array sharded ``P(AXIS)`` whose shard s owns rows
[s*local, (s+1)*local).  All primitives here run INSIDE ``shard_map`` on
the (local,)-shaped per-shard view; ``local`` and ``n_shards`` are static.
Validity is by caller convention (pad rows carry sentinel keys).

Primitive set (each is the distributed form of one XLA idiom the
single-device merge engine leans on — see engine/device_merge.py):

* ``dsort``       — global sample sort back to REGULAR layout (lax.sort)
* ``dcumsum`` / ``dcummax`` / ``dcummin_rev`` / ``dcummax_rev`` — global
  scans: local scan + exclusive shard-prefix exchange (one all_gather
  of a scalar per shard)
* ``dgather``     — routed cross-shard gather (out[j] = vals[idx[j]])
* ``dscatter``    — routed cross-shard scatter set/add/max (at[idx].op)
* ``dshift``      — global out[i] = vals[i+w] (adjacent-row compares)

Capacity contract: every bucket exchange sends through a
``(n_shards, cap)`` grid with ``cap = cap_factor * ceil(local/n_shards)``
(set per program via ``set_cap_factor``; ``None``/``>= n_shards`` falls
back to the full ``local`` grid).  Rows past a bucket's capacity are
DROPPED and the per-shard overflow flag is recorded in the active
``overflow_scope`` — the caller re-runs the program with a doubled
factor (sample-sort splitters make overflow rare; a factor of
``n_shards`` is exactly the old O(G) grid, so the retry chain always
terminates with a correct run).
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "mrg"
_TLS = threading.local()


def set_cap_factor(cf) -> None:
    """Set the exchange capacity factor for programs traced on THIS thread
    (stage programs pass it as a static jit arg and call this at trace
    entry, so the jit cache keys on it)."""
    _TLS.cap_factor = cf


def _cap_rows(local: int, n_shards: int) -> int:
    cf = getattr(_TLS, "cap_factor", None)
    if not cf or cf >= n_shards:
        return local
    return min(local, int(cf) * (-(-local // n_shards)) + 8)


def _note_overflow(flag) -> None:
    lst = getattr(_TLS, "overflow", None)
    if lst is not None:
        lst.append(flag)


@contextmanager
def overflow_scope():
    """Collect per-shard overflow flags of every capped exchange traced
    inside the scope (thread-local, so concurrent prewarm traces cannot
    cross-contaminate)."""
    old = getattr(_TLS, "overflow", None)
    _TLS.overflow = []
    try:
        yield _TLS.overflow
    finally:
        _TLS.overflow = old


def overflow_any(flags):
    """OR of collected flags across the mesh (psum), as an int64 scalar."""
    import jax
    if not flags:
        return jnp.zeros((), jnp.int64)
    local = jnp.zeros((), jnp.int64)
    for f in flags:
        local = local | f.astype(jnp.int64)
    return (jax.lax.psum(local, AXIS) > 0).astype(jnp.int64)
# Python int (jnp.int64 at import time would truncate to int32 when x64
# is off — dsort's default kmax would become 0 and kill every row)
I64_MAX = 1 << 62


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def shard(mesh: Mesh, arr, pad_val, local: int):
    """Host/np array -> regular-layout distributed array (padded to
    n_shards*local with pad_val)."""
    R = mesh.devices.size
    arr = np.asarray(arr)
    out = np.full(R * local, pad_val, arr.dtype)
    out[: len(arr)] = arr
    return jax.device_put(out, NamedSharding(mesh, P(AXIS)))


@functools.partial(jax.jit, static_argnames=("G", "vl"))
def _shard_dev_prep(a, G: int, vl: int):
    with jax.enable_x64(True):
        a64 = a[:vl].astype(jnp.int64)
        return jnp.concatenate(
            [a64, jnp.zeros(G - vl, jnp.int64)]) if G > vl else a64[:G]


def shard_dev(mesh: Mesh, arr, local: int, valid_len: int):
    """DEVICE array (int32/bool/uint8, zero-padded beyond valid_len) ->
    regular-layout distributed int64 array, without a host round trip:
    cast/pad on device, then reshard via device_put. The zero pad matches
    ``shard``'s pad_val=0 convention."""
    R = mesh.devices.size
    out = _shard_dev_prep(arr, G=R * local, vl=min(valid_len, arr.shape[0]))
    return jax.device_put(out, NamedSharding(mesh, P(AXIS)))


def _s():
    return jax.lax.axis_index(AXIS)


def gidx64(local: int):
    """Global row index of each local row (int64)."""
    return (_s().astype(jnp.int64) * local
            + jnp.arange(local, dtype=jnp.int64))


def _dtype_min(dt):
    return jnp.asarray(np.iinfo(np.dtype(dt.name)).min, dt)


def _dtype_max(dt):
    return jnp.asarray(np.iinfo(np.dtype(dt.name)).max, dt)


def _shard_prefix(total, n_shards: int, op: str, init):
    """Exclusive prefix (over earlier shards) of a per-shard scalar."""
    allv = jax.lax.all_gather(total, AXIS)
    mask = jnp.arange(n_shards) < _s()
    masked = jnp.where(mask, allv, init)
    if op == "sum":
        return jnp.sum(masked)
    if op == "max":
        return jnp.max(masked)
    return jnp.min(masked)


def _shard_suffix(total, n_shards: int, op: str, init):
    """Exclusive suffix (over later shards) of a per-shard scalar."""
    allv = jax.lax.all_gather(total, AXIS)
    mask = jnp.arange(n_shards) > _s()
    masked = jnp.where(mask, allv, init)
    if op == "sum":
        return jnp.sum(masked)
    if op == "max":
        return jnp.max(masked)
    return jnp.min(masked)


def dcumsum(vals, n_shards: int):
    c = jnp.cumsum(vals)
    pre = _shard_prefix(c[-1], n_shards, "sum", jnp.zeros((), vals.dtype))
    return c + pre


def dcumsum_rev(vals, n_shards: int):
    c = jnp.cumsum(vals[::-1])[::-1]
    suf = _shard_suffix(c[0], n_shards, "sum", jnp.zeros((), vals.dtype))
    return c + suf


def dcummax(vals, n_shards: int):
    c = jax.lax.cummax(vals)
    pre = _shard_prefix(c[-1], n_shards, "max", _dtype_min(vals.dtype))
    return jnp.maximum(c, pre)


def dcummin_rev(vals, n_shards: int):
    """Reverse running min (the rev_fill idiom of the merge engine)."""
    # flip+forward+flip (engine/device_merge._rev_fill_min rationale)
    c = jax.lax.cummin(vals[::-1])[::-1]
    suf = _shard_suffix(c[0], n_shards, "min", _dtype_max(vals.dtype))
    return jnp.minimum(c, suf)


def dcummax_rev(vals, n_shards: int):
    c = jax.lax.cummax(vals[::-1])[::-1]
    suf = _shard_suffix(c[0], n_shards, "max", _dtype_min(vals.dtype))
    return jnp.maximum(c, suf)


def dshift(vals, w, pad_val, local: int, n_shards: int):
    """Global out[i] = vals[i + w] for traced int w in (-G, G); rows
    shifted past either end take pad_val."""
    G = local * n_shards
    w64 = jnp.asarray(w, jnp.int64)
    if n_shards == 1:
        li = jnp.arange(local, dtype=jnp.int64)
        gi = li + w64
        return jnp.where((gi >= 0) & (gi < G),
                         vals[jnp.clip(gi, 0, local - 1)], pad_val)
    wpos = jnp.where(w64 >= 0, w64, w64 + G)  # rotate by wpos, mask later
    q = wpos // local
    r = wpos - q * local

    def rot(block, steps):
        steps = steps % n_shards
        if steps == 0:
            return block
        perm = [(src, (src - steps) % n_shards) for src in range(n_shards)]
        return jax.lax.ppermute(block, AXIS, perm)

    def rot_dyn(block, steps):
        out = block
        for bit in range(max(1, (2 * n_shards).bit_length())):
            amt = 1 << bit
            rotated = rot(out, amt)
            out = jnp.where((steps & amt) != 0, rotated, out)
        return out

    a = rot_dyn(vals, q)
    b = rot(a, 1)
    li = jnp.arange(local, dtype=jnp.int64)
    spliced = jnp.where(li + r < local,
                        a[jnp.minimum(li + r, local - 1)],
                        b[jnp.clip(li + r - local, 0, local - 1)])
    gi = gidx64(local) + w64
    return jnp.where((gi >= 0) & (gi < G), spliced, pad_val)


def _bucket_offsets(dest, n_shards: int):
    """Per-row offset within its destination bucket (dest values in
    [0, n_shards]; n_shards = dropped rows, offset 0)."""
    order = jnp.argsort(dest, stable=True)
    dsorted = dest[order]
    first = jnp.searchsorted(dsorted, jnp.arange(n_shards))
    offs_sorted = jnp.where(
        dsorted < n_shards,
        jnp.arange(dest.shape[0]) - first[jnp.minimum(dsorted,
                                                      n_shards - 1)], 0)
    # back to row order by scattering through the permutation (unique
    # indices). An argsort of ``order`` computes the same, but XLA's GPU
    # permutation-sort simplifier turns an int64 one into an ill-typed
    # scatter that the HLO verifier rejects.
    return jnp.zeros_like(offs_sorted).at[order].set(offs_sorted,
                                                     unique_indices=True)


def dgather(vals, q, oob_val, local_v: int, n_shards: int):
    """out[j] = global_vals[q[j]] for arbitrary int64 global indices
    (out-of-range -> oob_val). ``vals`` lives in a (local_v,)-per-shard
    domain; ``q`` may come from a different domain (any local length).
    Two padded all_to_alls: queries route to their owner shard, answers
    ride the inverse grid. A 1-shard mesh is a plain local gather (no
    routing, no offsets — the single-device degenerate case must not pay
    the exchange scaffolding)."""
    n_total = local_v * n_shards
    lq = q.shape[0]
    if n_shards == 1:
        inr = (q >= 0) & (q < n_total)
        return jnp.where(inr, vals[jnp.clip(q, 0, n_total - 1)], oob_val)
    inr = (q >= 0) & (q < n_total)
    qc = jnp.clip(q, 0, n_total - 1)
    dest = (qc // local_v).astype(jnp.int32)
    offs = _bucket_offsets(dest, n_shards)
    cap = _cap_rows(lq, n_shards)
    _note_overflow(jnp.any(inr & (offs >= cap)))
    sendq = jnp.zeros((n_shards, cap), jnp.int64)
    sendq = sendq.at[dest, offs].set(
        qc - dest.astype(jnp.int64) * local_v, mode="drop")
    recvq = jax.lax.all_to_all(sendq, AXIS, 0, 0, tiled=False)
    ans = vals[jnp.clip(recvq, 0, local_v - 1)]
    back = jax.lax.all_to_all(ans, AXIS, 0, 0, tiled=False)
    offs_c = jnp.minimum(offs, cap - 1)
    res = back[dest, offs_c]
    return jnp.where(inr & (offs < cap), res, oob_val)


def dscatter(base, idx, val, local_b: int, n_shards: int,
             mode: str = "set"):
    """Distributed base.at[idx].{set,add,max}(val) over int64 global idx
    (``base`` in a (local_b,)-per-shard domain; ``idx``/``val`` from any
    domain); out-of-range rows drop. ``set`` requires unique live indices
    (the engine's scatters are disjoint-write by construction). A 1-shard
    mesh is a plain local scatter."""
    G = local_b * n_shards
    live = (idx >= 0) & (idx < G)
    if n_shards == 1:
        at = jnp.where(live, idx, G)
        if mode == "set":
            return base.at[at].set(val, mode="drop")
        if mode == "add":
            return base.at[at].add(val, mode="drop")
        return base.at[at].max(val, mode="drop")
    idxc = jnp.clip(idx, 0, G - 1)
    dest = jnp.where(live, idxc // local_b, n_shards).astype(jnp.int32)
    slot = (idxc - (idxc // local_b) * local_b).astype(jnp.int32)
    offs = _bucket_offsets(dest, n_shards)
    lq = idx.shape[0]
    cap = _cap_rows(lq, n_shards)
    _note_overflow(jnp.any(live & (offs >= cap)))
    sendv = jnp.zeros((n_shards, cap), val.dtype)
    sendx = jnp.full((n_shards, cap), local_b, jnp.int32)
    sendv = sendv.at[dest, offs].set(jnp.where(live, val,
                                               jnp.zeros((), val.dtype)),
                                     mode="drop")
    sendx = sendx.at[dest, offs].set(jnp.where(live, slot, local_b),
                                     mode="drop")
    rv = jax.lax.all_to_all(sendv, AXIS, 0, 0, tiled=False).reshape(-1)
    rx = jax.lax.all_to_all(sendx, AXIS, 0, 0, tiled=False).reshape(-1)
    if mode == "set":
        return base.at[rx].set(rv, mode="drop")
    if mode == "add":
        return base.at[rx].add(jnp.where(rx < local_b, rv, 0), mode="drop")
    return base.at[rx].max(
        jnp.where(rx < local_b, rv, _dtype_min(val.dtype)), mode="drop")


def dscatter_rows(base2, idx, vals2, local_b: int, n_shards: int,
                  mode: str = "max"):
    """K-channel dscatter over ONE shared routing of ``idx``: base2
    (K, local_b) per shard, vals2 (K, L). The bucket-offset argsorts and
    the index exchange are computed once instead of per channel — the
    sharded tail stage's five segment fills share their scatter rows
    (engine/device_merge.tail_good_dev's (5, P) trick, mesh form)."""
    G = local_b * n_shards
    live = (idx >= 0) & (idx < G)
    if n_shards == 1:
        at = jnp.where(live, idx, G)
        if mode == "add":
            return base2.at[:, at].add(vals2, mode="drop")
        if mode == "set":
            return base2.at[:, at].set(vals2, mode="drop")
        return base2.at[:, at].max(vals2, mode="drop")
    K = vals2.shape[0]
    idxc = jnp.clip(idx, 0, G - 1)
    dest = jnp.where(live, idxc // local_b, n_shards).astype(jnp.int32)
    slot = (idxc - (idxc // local_b) * local_b).astype(jnp.int32)
    offs = _bucket_offsets(dest, n_shards)
    lq = idx.shape[0]
    cap = _cap_rows(lq, n_shards)
    _note_overflow(jnp.any(live & (offs >= cap)))
    lo = _dtype_min(vals2.dtype)
    dead = lo if mode == "max" else jnp.zeros((), vals2.dtype)
    sendv = jnp.full((K, n_shards, cap), dead, vals2.dtype)
    sendx = jnp.full((n_shards, cap), local_b, jnp.int32)
    sendv = sendv.at[:, dest, offs].set(
        jnp.where(live[None, :], vals2, dead), mode="drop")
    sendx = sendx.at[dest, offs].set(jnp.where(live, slot, local_b),
                                     mode="drop")
    rv = jax.lax.all_to_all(sendv, AXIS, 1, 1,
                            tiled=False).reshape(K, -1)
    rx = jax.lax.all_to_all(sendx, AXIS, 0, 0, tiled=False).reshape(-1)
    if mode == "set":
        return base2.at[:, rx].set(rv, mode="drop")
    if mode == "add":
        return base2.at[:, rx].add(
            jnp.where((rx < local_b)[None, :], rv, 0), mode="drop")
    return base2.at[:, rx].max(
        jnp.where((rx < local_b)[None, :], rv, lo), mode="drop")


def dcummax_rows(vals2, n_shards: int):
    """Row-wise dcummax of (K, local): one all_gather of the K tails
    replaces K separate shard-prefix exchanges."""
    c = jax.lax.cummax(vals2, axis=1)
    if n_shards == 1:
        return c
    allv = jax.lax.all_gather(c[:, -1], AXIS)          # (n_shards, K)
    mask = (jnp.arange(n_shards) < _s())[:, None]
    pre = jnp.max(jnp.where(mask, allv, _dtype_min(vals2.dtype)), axis=0)
    return jnp.maximum(c, pre[:, None])


def _route_contig(gpos, vals, fills, local: int, n_shards: int):
    """Contiguous-rank relayout: per-shard ASCENDING global ranks ``gpos``
    (dead rows >= G) into the regular layout, for several value channels
    at once.

    With the live-quantile-aligned splitters (dsort), each shard's rank
    range straddles its own regular slice give or take sampling error, so
    rows move at most a few shards: hop h in [-H, H] ships whole blocks
    by ppermute (H derived from the cap factor; rows needing a larger hop
    raise the overflow flag and the caller's retry widens H, falling back
    to the full (R, local) grid at factor >= R). Traffic is
    (2H+1)*(channels+1) local-size blocks instead of the old full
    (n_shards, local) all_to_all per channel — R times the data — plus it
    drops the two stable argsorts per channel the grid layout needed."""
    G = local * n_shards
    live = (gpos >= 0) & (gpos < G)
    if n_shards == 1:
        at = jnp.where(live, gpos, local)
        return [jnp.full(local, f, v.dtype).at[at].set(v, mode="drop")
                for v, f in zip(vals, fills)]
    cf = getattr(_TLS, "cap_factor", None)
    if not cf or cf >= n_shards:
        return [_route_rows(gpos, v, f, local, n_shards)
                for v, f in zip(vals, fills)]
    H = min(max(1, int(cf) // 4), n_shards - 1)
    s = _s().astype(jnp.int64)
    destq = jnp.where(live, gpos // local, 0)
    hop = jnp.where(live, destq - s, jnp.int64(1) << 40)
    _note_overflow(jnp.any(live & (jnp.abs(hop) > H)))
    slot = jnp.where(live, gpos - destq * local, local).astype(jnp.int32)
    outs = [jnp.full(local, f, v.dtype) for v, f in zip(vals, fills)]
    for hh in range(-H, H + 1):
        sel = live & (hop == hh)
        at = jnp.where(sel, slot, local)
        sent_m = jnp.zeros(local, jnp.int32).at[at].set(1, mode="drop")
        blocks = [jnp.full(local, f, v.dtype).at[at].set(v, mode="drop")
                  for v, f in zip(vals, fills)]
        if hh != 0:
            perm = [(src, (src + hh) % n_shards)
                    for src in range(n_shards)]
            sent_m = jax.lax.ppermute(sent_m, AXIS, perm)
            blocks = [jax.lax.ppermute(bv, AXIS, perm) for bv in blocks]
        outs = [jnp.where(sent_m == 1, bv, o)
                for bv, o in zip(blocks, outs)]
    return outs


def _route_rows(gpos, val, fill, local: int, n_shards: int):
    """Rows of the irregular (n_shards*local,) exchange layout -> the
    regular layout at global positions ``gpos`` (unique; out-of-range rows
    drop). Regular slots receiving no row take ``fill``. Full-width
    fallback of _route_contig (capacity-unbounded)."""
    G = local * n_shards
    live = (gpos >= 0) & (gpos < G)
    gc = jnp.clip(gpos, 0, G - 1)
    dest = jnp.where(live, gc // local, n_shards).astype(jnp.int32)
    slot = (gc - (gc // local) * local).astype(jnp.int32)
    # per (src, dest) the rows are <= local (dest has only local slots and
    # gpos is unique), but my rows sharing a dest need distinct bucket
    # offsets
    offs = _bucket_offsets(dest, n_shards)
    # NOT capped: this is the contiguous-rank relayout — a source's live
    # rows map to CONSECUTIVE global ranks, so a single (src, dest) cell
    # structurally carries up to ``local`` rows whenever one source holds
    # a destination's whole slice. The splitter-balanced bucket exchange
    # (dsort) and the query routers (dgather/dscatter) are the capped
    # ones; replacing this full-width relayout with rotation-based
    # placement is the remaining capacity TODO.
    sendv = jnp.zeros((n_shards, local), val.dtype)
    sendx = jnp.full((n_shards, local), local, jnp.int32)
    sendv = sendv.at[dest, offs].set(val, mode="drop")
    sendx = sendx.at[dest, offs].set(slot, mode="drop")
    rv = jax.lax.all_to_all(sendv, AXIS, 0, 0, tiled=False).reshape(-1)
    rx = jax.lax.all_to_all(sendx, AXIS, 0, 0, tiled=False).reshape(-1)
    out = jnp.full(local, fill, val.dtype)
    return out.at[rx].set(rv, mode="drop")


def dsort(keys, payloads, local: int, n_shards: int, kmax=I64_MAX):
    """Globally sort rows by ``keys`` (1 or 2 int64 operands, ascending)
    carrying ``payloads``; returns (keys_out, payloads_out) in REGULAR
    layout (each a list). Pad convention: rows with keys[0] >= kmax are
    pads and come out at the global tail in an arbitrary stable order.

    Sample sort: local sort -> all_gather'd splitter candidates ->
    padded-bucket all_to_all -> local re-sort -> route every row back to
    the regular layout at its global rank. A 1-shard mesh is ONE local
    lax.sort (the exchange/splitter/relayout machinery priced the r4
    primary_shmerge bench at 0.036x on the single real chip).
    """
    two = len(keys) == 2
    k0 = keys[0]
    k1 = keys[1] if two else jnp.zeros_like(k0)
    if n_shards == 1:
        ops = jax.lax.sort((k0, k1, *payloads), num_keys=2)
        kmax_t = jnp.asarray(kmax, k0.dtype)
        live = ops[0] < kmax_t
        outs = [jnp.where(live, ops[0], kmax_t)]
        if two:
            outs.append(jnp.where(live, ops[1], kmax_t))
        pays_out = [jnp.where(live, p, jnp.zeros((), p.dtype))
                    for p in ops[2:]]
        return outs, pays_out
    ops = jax.lax.sort((k0, k1, *payloads), num_keys=2)
    k0s, k1s, pays = ops[0], ops[1], list(ops[2:])

    # live-quantile-aligned splitters: candidates sample each shard's
    # LIVE prefix, and boundary b targets global live rank b*local — so
    # bucket b's rows are (approximately) exactly the rows whose final
    # regular home is shard b. That balances the exchange AND makes the
    # post-sort rank relayout near-local (_route_contig hops ~ +-1).
    # The old fixed-stride sampling included pad keys: with sparse
    # domains the live rows piled into the low buckets and the relayout
    # needed the full-width grid.
    live_in = k0s < jnp.asarray(kmax, k0.dtype)
    nlive_loc = jnp.sum(live_in.astype(jnp.int64))
    cand = jnp.minimum((jnp.arange(n_shards, dtype=jnp.int64)
                        * nlive_loc) // n_shards, local - 1)
    g0 = jax.lax.all_gather(k0s[cand], AXIS, tiled=True)
    g1 = jax.lax.all_gather(k1s[cand], AXIS, tiled=True)
    g0, g1 = jax.lax.sort((g0, g1), num_keys=2)
    glive = jax.lax.psum(nlive_loc, AXIS)
    nc = n_shards * n_shards
    b_arr = jnp.arange(1, n_shards, dtype=jnp.int64)
    frac_rank = jnp.clip((b_arr * local * nc) // jnp.maximum(glive, 1),
                         0, nc - 1)
    kmax0 = jnp.asarray(kmax, k0.dtype)
    beyond = b_arr * local >= glive
    s0 = jnp.where(beyond, kmax0, g0[frac_rank])
    s1 = jnp.where(beyond, kmax0, g1[frac_rank])

    below = (s0[None, :] < k0s[:, None]) | \
        ((s0[None, :] == k0s[:, None]) & (s1[None, :] <= k1s[:, None]))
    dest = jnp.sum(below.astype(jnp.int32), axis=1)
    # pad rows (keys >= kmax) are never routed — receivers reconstruct
    # them as fills — so they must not consume bucket capacity
    dest = jnp.where(live_in, dest, n_shards)
    # rows are locally sorted => dest non-decreasing => offset by first
    first = jnp.searchsorted(dest, jnp.arange(n_shards), side="left")
    offs = jnp.arange(local) - first[jnp.minimum(dest, n_shards - 1)]
    offs = jnp.where(live_in, offs, 0)
    cap = _cap_rows(local, n_shards)
    _note_overflow(jnp.any(live_in & (offs >= cap)))

    def exch(arr, fill):
        send = jnp.full((n_shards, cap), fill, arr.dtype)
        send = send.at[jnp.where(live_in, dest, n_shards), offs].set(
            arr, mode="drop")
        return jax.lax.all_to_all(send, AXIS, 0, 0,
                                  tiled=False).reshape(-1)

    r0 = exch(k0s, jnp.asarray(kmax, k0.dtype))
    r1 = exch(k1s, jnp.asarray(kmax, k1.dtype))
    rp = [exch(p, jnp.zeros((), p.dtype)) for p in pays]
    m = jax.lax.sort((r0, r1, *rp), num_keys=2)
    m0, m1, mp = m[0], m[1], list(m[2:])

    rows = m0.shape[0]
    ri = jnp.arange(rows, dtype=jnp.int64)
    live = m0 < kmax
    nlive = jnp.sum(live.astype(jnp.int64))
    pads_before = jnp.cumsum((~live).astype(jnp.int64)) - (~live)
    live_rank = ri - pads_before
    pre_live = _shard_prefix(nlive, n_shards, "sum", jnp.int64(0))
    G = local * n_shards
    # input pad rows and exchange fills both carry kmax keys — neither is
    # routed; output tail slots take the explicit fills (keys kmax,
    # payloads 0), which is the pad convention downstream stages assume
    gpos = jnp.where(live, pre_live + live_rank, jnp.int64(G))
    vals = [m0] + ([m1] if two else []) + mp
    fills = [jnp.asarray(kmax, k0.dtype)] \
        + ([jnp.asarray(kmax, k1.dtype)] if two else []) \
        + [jnp.zeros((), p.dtype) for p in mp]
    routed = _route_contig(gpos, vals, fills, local, n_shards)
    keys_out = routed[: (2 if two else 1)]
    pays_out = routed[(2 if two else 1):]
    return keys_out, pays_out
