"""Head-jumping matching-statistics scan: per-PHRASE work instead of
per-character work — the device form of the reference's compressed
(PLCP-skip) trick, ref ``CMS-BWT-functions.cpp:357-403``.

The dense backend (ops/ms_dense) joint-sorts every collection character;
its cost is divergence-insensitive. The reference, by contrast, spends
real work only at phrase HEADS (the skip loop slides over tails in O(1)
each, ref :381-395) — which is why a single CPU core wins at very low
divergence (pangenome-like collections). This kernel matches that scaling
on device:

* the skip run after a factor is ONE range-max descent instead of a
  per-character loop: with g[p] = p + PLCP[p], the run continues while
  g[pos+1+k] < pos + len + 1, so its length is found by "first p with
  g[p] >= T" on a sparse table of window maxima (O(log n) gathers);
* tails are never materialized — only candidate head records (position,
  pos, len, smaller) are emitted; the downstream merge derives every tail
  from head spans (engine/device_merge.fixup_dev), exactly as it already
  does for the dense backend;
* extension at a head reuses the lane state machine of ops/ms_device
  (windowed singleton compares + fused binary-search rounds, validated
  byte-exact), restructured into phase-separated loops: an inner loop
  runs ONLY the extension machinery until every lane's factor finalizes,
  then one batched skip+adjust step advances all lanes to their next
  head. Per-wave cost is O(lanes * window + lanes * log n) — per-head,
  not per-char.

Chunking is exact without carried state: MS values are pure functions of
(reference, collection), so a lane entering a chunk cold lands on the
canonical factor chain (the ops/ms_device argument). Candidate records
are concatenated across lanes in text order and the head flag is decided
globally: candidate c with predecessor p is a head iff
``c.pos != p.pos + (c.t - p.t)`` (the positions between consecutive
candidates are p's tail chain) — which is the reference's
``pos != prevPos + 1`` test, ref :360.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SEPARATOR
from ..index.device import (DeviceIndex, build_device_index,
                            sparse_table_levels)
from .ms_device import _bs_rounds

INT_MAX = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("n",))
def build_gmax_table(plcp: jnp.ndarray, n: int) -> jnp.ndarray:
    """gmax[k][p] = max(g[p .. p+2^k)) for g[p] = p + PLCP[p] (padded with
    -1 past n). 'First p >= start with g[p] >= T' descends this table —
    the batched replacement for the reference's per-char skip loop."""
    levels = sparse_table_levels(n)
    idx = jnp.arange(n, dtype=jnp.int32)
    g = idx + plcp[:n]
    gmax = jnp.zeros((levels, n), jnp.int32).at[0].set(g)

    def level(gmax, k):
        half = jnp.int32(1) << (k - 1)
        prev = gmax[k - 1]
        other = jnp.where(idx + half < n,
                          prev[jnp.minimum(idx + half, n - 1)], -1)
        return gmax.at[k].set(jnp.maximum(prev, other)), None

    gmax, _ = jax.lax.scan(level, gmax,
                           jnp.arange(1, levels, dtype=jnp.int32))
    return gmax


def next_ge_device(gmax: jnp.ndarray, start: jnp.ndarray, t_val: jnp.ndarray,
                   n: int) -> jnp.ndarray:
    """Vector query: smallest p >= start with g[p] >= t_val (p < n), else
    n. Since g[p] >= p, the answer is <= t_val whenever t_val < n."""
    levels = gmax.shape[0]
    d = jnp.zeros_like(start)

    def level(d, k):
        w = jnp.int32(1) << k
        s = start + d
        ok = s + w <= n
        mx = gmax[k][jnp.clip(s, 0, n - 1)]
        take = ok & (mx < t_val)
        return d + jnp.where(take, w, 0), None

    d, _ = jax.lax.scan(level, d,
                        jnp.arange(levels - 1, -1, -1, dtype=jnp.int32))
    res = start + d
    # the descent lands on the first window whose max clears T; the single
    # remaining element is it (all power-of-two prefixes below failed)
    return jnp.minimum(res, n)


def _psv_nsv_fused(jump, pi, ni, ub, n: int):
    """(psv_device(jump, pi, ub, n), nsv_device(jump, ni, ub, n)) with the
    two descents' per-level gathers fused into one (XLA gathers on this
    chip are latency-bound at lane counts <= ~8K, so halving the number of
    dependent gather rounds nearly halves the adjust phase)."""
    levels = jump.shape[0]
    L = pi.shape[0]
    dp = jnp.zeros_like(pi)
    dn = jnp.zeros_like(ni)

    def level(carry, k):
        dp, dn = carry
        w = jnp.int32(1) << k
        sp = pi - dp - w + 1
        okp = sp >= 0
        sn_ = ni + dn
        okn = sn_ + w <= n
        q = jnp.concatenate([jnp.maximum(sp, 0),
                             jnp.minimum(sn_, n - 1)])
        vals = jump[k][q]
        vp = vals[:L]
        vn = vals[L:]
        dp = dp + jnp.where(okp & (vp >= ub), w, 0)
        dn = dn + jnp.where(okn & (vn >= ub), w, 0)
        return (dp, dn), None

    (dp, dn), _ = jax.lax.scan(
        level, (dp, dn), jnp.arange(levels - 1, -1, -1, dtype=jnp.int32))
    rp = pi - dp
    rn = ni + dn
    return (jnp.where(rp >= 0, rp, -1),
            jnp.where(rn < n, rn, -1))


@functools.partial(jax.jit,
                   static_argnames=("n", "sn", "cap", "window",
                                    "max_iters"),
                   donate_argnums=(7,))
def ms_jump_step(x_padded, sa, isa, plcp, jump, gmax, sx_padded,
                 state, chunk_ends, *, n: int, sn: int,
                 cap: int, window: int, max_iters: int):
    """Run up to ``max_iters`` iterations of the phase-separated
    head-jumping scan and return the updated state (donated in place).

    The host drives repeated steps until every lane is done, so no
    single device program runs unbounded at collection scale.
    """
    L = chunk_ends.shape[0]
    W = window
    ROUNDS = _bs_rounds(n)
    karange = jnp.arange(W, dtype=jnp.int32)
    row = jnp.arange(L, dtype=jnp.int32)

    def extend_body(st):
        t = st["t"]
        length = st["length"]
        lb = st["lb"]
        rb = st["rb"]
        pos = st["pos"]
        fin = st["fin"]
        done = st["done"]

        act = ~done & ~fin
        cur_char = sx_padded[jnp.clip(t, 0, sn + W - 1)]
        sep_emit = act & (length == 0) & (cur_char == SEPARATOR)

        singleton = act & ~sep_emit & (lb == rb)
        j_abs = t + length
        win_sx = sx_padded[jnp.clip(j_abs[:, None] + karange[None, :],
                                    0, sn + W - 1)]
        win_x = x_padded[jnp.clip(pos[:, None] + length[:, None]
                                  + karange[None, :],
                                  0, x_padded.shape[0] - 1)]
        neq = win_sx != win_x
        any_neq = jnp.any(neq, axis=1)
        dmm = jnp.argmax(neq, axis=1).astype(jnp.int32)
        dmm = jnp.where(any_neq, dmm, W)
        sgl_final = singleton & any_neq
        sgl_smaller = win_x[row, jnp.clip(dmm, 0, W - 1)] > \
            win_sx[row, jnp.clip(dmm, 0, W - 1)]

        nons = act & ~sep_emit & (lb != rb)
        c = sx_padded[jnp.clip(j_abs, 0, sn + W - 1)]

        def bs_cond(carry):
            lo1, hi1, lo2, hi2, r = carry
            live = nons & ((lo1 < hi1) | (lo2 < hi2))
            return jnp.any(live) & (r < ROUNDS)

        def bs_round(carry):
            lo1, hi1, lo2, hi2, r = carry
            m1 = (lo1 + hi1) >> 1
            m2 = (lo2 + hi2) >> 1
            # one fused probe pair: gather SA then text for both bounds
            m12 = jnp.concatenate([m1, m2])
            s12 = sa[jnp.clip(m12, 0, n - 1)]
            len2 = jnp.concatenate([length, length])
            k12 = x_padded[jnp.clip(s12 + len2, 0,
                                    x_padded.shape[0] - 1)]
            k1 = k12[:m1.shape[0]]
            k2 = k12[m1.shape[0]:]
            go1 = k1 < c
            lo1n = jnp.where(go1, m1 + 1, lo1)
            hi1n = jnp.where(go1, hi1, m1)
            a1 = lo1 < hi1
            lo1 = jnp.where(a1, lo1n, lo1)
            hi1 = jnp.where(a1, hi1n, hi1)
            go2 = k2 <= c
            lo2n = jnp.where(go2, m2 + 1, lo2)
            hi2n = jnp.where(go2, hi2, m2)
            a2 = lo2 < hi2
            lo2 = jnp.where(a2, lo2n, lo2)
            hi2 = jnp.where(a2, hi2n, hi2)
            return lo1, hi1, lo2, hi2, r + 1

        lower, _, upper, _, _ = jax.lax.while_loop(
            bs_cond, bs_round, (lb, rb + 1, lb, rb + 1, jnp.int32(0)))
        bs_found = nons & (lower < upper)
        insertion = lower
        at_end = insertion == rb + 1
        bs_maxmatch = jnp.where(at_end, rb, insertion)
        bs_smaller = ~at_end
        bs_final = nons & (lower >= upper)

        new_lb = jnp.where(bs_found, lower, lb)
        new_rb = jnp.where(bs_found, upper - 1, rb)
        new_pos = jnp.where(bs_found, sa[jnp.clip(lower, 0, n - 1)], pos)
        new_len = length + jnp.where(bs_found, 1, 0) \
            + jnp.where(singleton, dmm, 0)
        final = sgl_final | bs_final
        fpos = jnp.where(bs_final,
                         sa[jnp.clip(bs_maxmatch, 0, n - 1)], new_pos)
        fsml = jnp.where(bs_final, bs_smaller, sgl_smaller)

        emit_now = final | sep_emit
        e_pos = jnp.where(sep_emit, n - 1, fpos)
        e_len = jnp.where(sep_emit, 0, new_len)
        e_sml = jnp.where(sep_emit, False, fsml)
        nrec = st["nrec"]
        colcap = jnp.minimum(nrec, cap)
        col = jnp.where(emit_now, colcap, cap)  # col==cap drops the write
        rec = dict(col=col, t=t, pos=e_pos, length=e_len, sml=e_sml)
        viol = st["viol"] | (emit_now & (nrec >= cap))
        nrec = nrec + jnp.where(emit_now, 1, 0)

        t = t + jnp.where(emit_now, 1, 0)
        # separator: full reset, keep extending (unless chunk exhausted);
        # factor: park for the batched skip+adjust step
        length = jnp.where(sep_emit, 0,
                           jnp.where(final, new_len - 1,
                                     jnp.where(act, new_len, length)))
        lb = jnp.where(sep_emit, 0, jnp.where(act & ~final, new_lb, lb))
        rb = jnp.where(sep_emit, n - 1,
                       jnp.where(act & ~final, new_rb, rb))
        pos = jnp.where(sep_emit, n - 1,
                        jnp.where(final, fpos,
                                  jnp.where(act, new_pos, pos)))
        fin = fin | final
        done = done | (act & (t >= chunk_ends))
        return {**st, "t": t, "length": length, "lb": lb, "rb": rb,
                "pos": pos, "fin": fin, "done": done, "nrec": nrec,
                "viol": viol}, rec

    def skip_adjust_body(st):
        # ---- batched skip + adjust (lanes parked by finalize) ----
        t = st["t"]
        length = st["length"]
        lb = st["lb"]
        rb = st["rb"]
        pos = st["pos"]
        done = st["done"]
        park = st["fin"] & ~done
        # skip run: first p >= pos+1 with g[p] >= pos + length + 1
        p_found = next_ge_device(
            gmax, jnp.clip(pos + 1, 0, n), pos + length + 1, n)
        q = jnp.clip(p_found - (pos + 1), 0, None)
        q = jnp.where(park, jnp.minimum(q, chunk_ends - t), 0)
        t = t + q
        pos = pos + q
        length = length - jnp.where(park, q, 0)
        done = done | (park & (t >= chunk_ends))
        alive = park & ~ (t >= chunk_ends)
        # adjust (ref :11-43): singleton re-expands around ISA[pos+1];
        # wide intervals contract through ISA[SA[.]+1]; root stays root
        adj_sgl = alive & (lb == rb)
        adj_wide = alive & (lb != rb)
        suflo = sa[jnp.clip(lb, 0, n - 1)]
        sufhi = sa[jnp.clip(rb, 0, n - 1)]
        at_root = adj_wide & ((suflo == n - 1) | (sufhi == n - 1))
        qlo = jnp.where(adj_sgl,
                        isa[jnp.clip(pos + 1, 0, n - 1)],
                        isa[jnp.clip(suflo + 1, 0, n - 1)])
        qhi = jnp.where(adj_sgl,
                        isa[jnp.clip(pos + 1, 0, n - 1)],
                        isa[jnp.clip(sufhi + 1, 0, n - 1)])
        p, qn = _psv_nsv_fused(jump, qlo, qhi + 1, length, n)
        p = jnp.where(p == -1, 0, p)
        qn = jnp.where(qn == -1, n - 1, qn - 1)
        adj_apply = alive & ~at_root
        lb = jnp.where(adj_apply, p, jnp.where(at_root, 0, lb))
        rb = jnp.where(adj_apply, qn, jnp.where(at_root, n - 1, rb))
        pos = jnp.where(alive, sa[jnp.clip(lb, 0, n - 1)], pos)
        fin = st["fin"] & ~alive  # alive lanes resume extending
        rec = dict(col=jnp.full(L, cap, jnp.int32),
                   t=t, pos=t, length=t, sml=jnp.zeros(L, bool))
        return {**st, "t": t, "length": length, "lb": lb, "rb": rb,
                "pos": pos, "fin": fin, "done": done}, rec

    # ONE while loop; each iteration runs EITHER an extension step (some
    # lane still mid-factor) OR the batched skip+adjust wave step — a
    # lax.cond on one scalar keeps per-iteration cost to a single phase
    # without nesting while_loops.
    # Every iteration: extension step for mid-factor lanes, then the
    # skip+adjust step for lanes that are parked — MASKED per lane, with
    # NO global barrier. (A cond that waits for all lanes to park
    # multiplies the per-lane maxima: with thousands of desynchronized
    # lanes the barrier made iteration count explode ~10x.)
    def wave_body(carry):
        st, out, it = carry
        st, rec = extend_body(st)
        st, _ = skip_adjust_body(st)
        col = rec["col"]  # col == cap drops the write
        out = dict(
            t=out["t"].at[row, col].set(rec["t"], mode="drop"),
            pos=out["pos"].at[row, col].set(rec["pos"], mode="drop"),
            length=out["length"].at[row, col].set(rec["length"],
                                                  mode="drop"),
            sml=out["sml"].at[row, col].set(rec["sml"], mode="drop"))
        return st, out, it + 1

    def wave_cond(carry):
        st, out, it = carry
        return jnp.any(~st["done"]) & (it < max_iters)

    out0 = dict(t=state.pop("out_t"), pos=state.pop("out_pos"),
                length=state.pop("out_len"), sml=state.pop("out_sml"))
    st, out, _ = jax.lax.while_loop(wave_cond, wave_body,
                                    (state, out0, jnp.int32(0)))
    st["out_t"] = out["t"]
    st["out_pos"] = out["pos"]
    st["out_len"] = out["length"]
    st["out_sml"] = out["sml"]
    return st


def jump_init_state(chunk_starts, chunk_ends, L: int, n: int, cap: int):
    # numpy-built + one explicit upload per field (transfer-guard-clean)
    state = {
        "t": np.asarray(chunk_starts, np.int32),
        "length": np.zeros(L, np.int32),
        "lb": np.zeros(L, np.int32),
        "rb": np.full(L, n - 1, np.int32),
        "pos": np.full(L, n - 1, np.int32),
        "fin": np.zeros(L, bool),
        "done": np.asarray(chunk_starts >= chunk_ends),
        "nrec": np.zeros(L, np.int32),
        "viol": np.zeros(L, bool),
        "out_t": np.zeros((L, cap), np.int32),
        "out_pos": np.zeros((L, cap), np.int32),
        "out_len": np.zeros((L, cap), np.int32),
        "out_sml": np.zeros((L, cap), np.bool_),
    }
    return {k: jax.device_put(v) for k, v in state.items()}


@functools.partial(jax.jit, static_argnames=("cap", "sn", "h_pad"))
def _compact_candidates(out_t, out_pos, out_len, out_sml, nrec, sx_padded,
                        cap: int, sn: int, h_pad: int):
    """Concatenate per-lane candidate records in text order, apply the
    global head test, and compact true heads (+ the head char =
    previous collection char, cyclic)."""
    L = out_t.shape[0]
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = slot < nrec[:, None]
    key = jnp.where(valid, out_t, INT_MAX).reshape(-1)
    t_f, pos_f, len_f, sml_f = jax.lax.sort(
        (key, out_pos.reshape(-1), out_len.reshape(-1),
         out_sml.reshape(-1).astype(jnp.int32)), num_keys=1)
    total = jnp.sum(valid.astype(jnp.int32))
    rows = jnp.arange(L * cap, dtype=jnp.int32)
    vs = rows < total
    prev_t = jnp.concatenate([jnp.full(1, -1, jnp.int32), t_f[:-1]])
    prev_pos = jnp.concatenate([jnp.full(1, -2, jnp.int32), pos_f[:-1]])
    is_head = vs & (pos_f != prev_pos + (t_f - prev_t))
    is_head = is_head | (vs & (rows == 0))
    sml = (sml_f != 0) & is_head
    h = jnp.sum(is_head.astype(jnp.int32))
    hkey = jnp.where(is_head, rows, INT_MAX)
    _, t_h, pos_h, len_h, sml_h = jax.lax.sort(
        (hkey, t_f, pos_f, len_f, sml.astype(jnp.int32)), num_keys=1)
    sl = lambda a: jax.lax.dynamic_slice(a, (0,), (h_pad,))
    t_h = sl(t_h)
    hvalid = jnp.arange(h_pad, dtype=jnp.int32) < h
    prev_idx = jnp.where(t_h > 0, t_h - 1, sn - 1)
    chr_h = jnp.where(hvalid,
                      sx_padded[jnp.clip(prev_idx, 0, sn - 1)],
                      jnp.uint8(0))
    zero = lambda a: jnp.where(hvalid, sl(a), 0)
    return (jnp.where(hvalid, t_h, 0), zero(pos_h), zero(len_h),
            zero(sml_h) != 0, chr_h, h)


def ms_jump_heads(x_aug: np.ndarray, sx: np.ndarray, lanes: int = 4096,
                  window: int = 64, index: DeviceIndex | None = None):
    """Run the jump scan end-to-end on device; returns a DeviceHeadsResult
    (ops/ms_dense layout) ready for engine/device_merge — the low-
    divergence production path (auto-dispatch lives in the pipeline)."""
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    from .ms_dense import DeviceHeadsResult, _stage_timer
    enable_compilation_cache()
    mark = _stage_timer()
    sn = int(len(sx))
    if index is None:
        index = build_device_index(np.asarray(x_aug))
    n = index.n
    gmax = build_gmax_table(index.plcp, n)
    mark("jump_index")
    lanes = max(1, min(lanes, sn))
    chunk_len = -(-sn // lanes)
    starts = (np.arange(lanes) * chunk_len).astype(np.int32)
    ends = np.minimum(starts + chunk_len, sn).astype(np.int32)
    sx_np = np.asarray(sx)
    sx_dev = jax.device_put(
        np.concatenate([sx_np, np.zeros(window, np.uint8)]))
    cap = max(64, bucket_size(int(3 * chunk_len // 16 + 64)))
    ends_dev = jnp.asarray(ends)
    max_iters = 512
    while True:
        state = jump_init_state(starts, ends, lanes, n, cap)
        while True:
            state = ms_jump_step(
                index.x_padded, index.sa, index.isa, index.plcp,
                index.jump, gmax, sx_dev, state, ends_dev,
                n=n, sn=sn, cap=cap, window=window, max_iters=max_iters)
            flags = jax.device_get(_status_flags(state["done"],
                                                 state["viol"]))
            if flags[1] or not flags[0]:
                break
        out_t, out_pos = state["out_t"], state["out_pos"]
        out_len, out_sml = state["out_len"], state["out_sml"]
        nrec, viol = state["nrec"], state["viol"]
        if not bool(flags[1]):
            break
        cap = bucket_size(cap * 2 + 1)
        if cap > max(2 * chunk_len, 1024):
            raise RuntimeError("ms_jump: record capacity runaway")
    mark("jump_scan")
    h_pad = min(bucket_size(int(jax.device_get(_sum_i64(nrec))) + 1),
                lanes * cap)
    t_h, pos_h, len_h, sml_h, chr_h, h_dev = _compact_candidates(
        out_t, out_pos, out_len, out_sml, nrec, sx_dev, cap, sn, h_pad)
    h = int(jax.device_get(h_dev))
    mark("jump_compact(h=%d)" % h)
    # reference index in merge layout (zero-padded n_pad)
    n_pad = bucket_size(n + 1)
    ref_sa, ref_isa, ref_bwt = _ref_pad(index.sa, index.isa, index.bwt,
                                        jax.device_put(np.int32(n)), n_pad)
    # head arrays may exceed the merge's preferred bucket; re-bucket
    hb = bucket_size(h + 1)
    if hb < h_pad:
        t_h, pos_h, len_h, sml_h, chr_h = (
            a[:hb] for a in (t_h, pos_h, len_h, sml_h, chr_h))
    return DeviceHeadsResult(
        head_t=t_h, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=0)


@jax.jit
def _status_flags(done, viol):
    return jnp.stack([jnp.any(~done), jnp.any(viol)])


@jax.jit
def _sum_i64(a):
    return jnp.sum(a)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _ref_pad(sa, isa, bwt, n, n_pad: int):
    def pad(a, dt):
        src = a.shape[0]
        if src < n_pad:
            a = jnp.concatenate([a, jnp.zeros(n_pad - src, a.dtype)])
        a = a[:n_pad]
        mask = jnp.arange(n_pad, dtype=jnp.int32) < n
        return jnp.where(mask, a, jnp.zeros((), a.dtype)).astype(dt)
    return pad(sa, jnp.int32), pad(isa, jnp.int32), pad(bwt, jnp.uint8)
