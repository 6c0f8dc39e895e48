"""Sharded downstream merge: head fixup -> grouping -> ranking -> tail
positioning -> run assembly over a DEVICE MESH — no stage gathers the head
records to one device.

This is the distributed form of engine/device_merge.py (same reference
semantics, ref CMS-BWT-functions.cpp:566-1085), built from the collective
vocabulary of parallel/dist.py:

* every ``lax.sort`` join becomes a sample-sort ``dsort`` whose bucket
  exchange IS the SURVEY-mandated all-to-all reshard (the distributed
  ``(pos, idx)`` head sort of ref :588-593 and the tail-bucket reshard of
  ref :1517-1603);
* every global scan (cummax fills, cumsum credits, offsets) becomes a
  local scan plus an exclusive shard-prefix exchange;
* the tail-positioning slot counters accumulate per shard and combine by
  routed scatter-add — the "psum'd slot counters" of the design;
* the per-shard run lists concatenate on the host after one download per
  shard (the all-gather of partial results).

Domains (regular layout, shard s owns rows [s*local, (s+1)*local)):
  H — heads and classes        (local_h rows/shard, G_H >= h + 2)
  N — reference positions      (local_n rows/shard, G_N >= n + 2)
  P — expanded tail pairs      (local_p rows/shard)
  J — tail join (H ++ P concatenated per shard)
  E — run-emission lanes (4xH ++ N concatenated per shard)

All arithmetic is int64 (enable_x64 inside the programs): the sharded
merge is also the capacity route for collections past the int32 device
merge bound (CMS-BWT.h:26,46 — sn is uint64 in the reference).

Exchange capacity: the sample-sort bucket exchanges and the query
routers run on (R, cap_factor*local/R + 8) grids with drop-and-retry on
overflow (parallel/dist.py capacity contract; driver loop in
merge_heads_sharded doubles the factor until clean, terminating at the
full-local grid, and remembers the working factor per mesh size).
_dist_suffix_sort skips doubling rounds once every rank is distinct
(replicated done flag); the run list downloads as 1-byte packed
per-shard geometric tiers (device_merge's download scheme).

Validated byte-equal against the single-device merge and the host engine
on the virtual 8-device CPU mesh (tests/test_sharded_merge.py) and by
``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from . import dist as D
from ..utils.xfer import get_global as _gg
from .dist import (AXIS, dcummax, dcummax_rev, dcummax_rows, dcummin_rev,
                   dcumsum, dgather, dscatter, dscatter_rows, dshift,
                   dsort, gidx64)

I64 = jnp.int64
# Python int, NOT jnp.int64(...): at import time x64 is typically disabled
# and jnp.int64 silently truncates to int32 (BIG would become 0, making
# every dsort's kmax 0 and every row dead). Weak typing adopts int64 from
# the other operand inside the enable_x64 programs.
BIG = 1 << 62


def _tot(x):
    return jax.lax.psum(jnp.sum(x), AXIS)


def _bcast0(vals):
    """Value of global row 0 (shard 0's first element), on every shard."""
    return jax.lax.all_gather(vals[0], AXIS)[0]


# ---------------------------------------------------------------------------
# Stage 1+2+3a: fixup, grouping, class ranks (H + N domains)
# ---------------------------------------------------------------------------

def _fixup(t, pos, ln, h, ref_isa, lh: int, ln_: int, R: int):
    """to_next / isa_next / succ per head (ref :566-586); transcription of
    device_merge.fixup_dev with global scans and routed gathers."""
    idx = gidx64(lh)
    G = lh * R
    valid = idx < h
    ends = jnp.where(valid, t + ln, BIG)
    pseudo = valid & (ln == 0)
    barrier = dcummin_rev(jnp.where(pseudo, idx, I64(G)), R)
    ends_nxt = dshift(ends, I64(1), BIG + 1, lh, R)
    is_run_end = ends_nxt != ends
    run_end = dcummin_rev(jnp.where(is_run_end, idx, I64(G)), R)
    j = jnp.minimum(run_end + 1, barrier)
    j = jnp.where(pseudo, idx, j)
    t_nxt = dshift(t, I64(1), I64(0), lh, R)
    to_next = jnp.where(valid & (ln > 0), t_nxt - t - 1, 0)
    pos_j = dgather(pos, j, I64(0), lh, R)
    t_j = dgather(t, j, I64(0), lh, R)
    img = pos_j + (ends - t_j)
    isa_next = jnp.where(
        valid, dgather(ref_isa, jnp.clip(img, 0, ln_ * R - 1), I64(0),
                       ln_, R), 0)
    return to_next, isa_next, j


def _tail_counts(pos, to_next, h, lh: int, ln_: int, R: int):
    """Tails per reference position (difference array over N, ref
    :368-377)."""
    idx = gidx64(lh)
    valid = (idx < h) & (to_next > 0)
    hp = jnp.where(valid, pos + 1, I64(-1))
    diff = jnp.zeros(ln_, I64)
    diff = dscatter(diff, hp, jnp.ones(lh, I64), ln_, R, mode="add")
    diff = dscatter(diff, jnp.where(valid, hp + to_next, I64(-1)),
                    jnp.full(lh, -1, I64), ln_, R, mode="add")
    return dcumsum(diff, R)


def _group(t, pos, ln, smaller, to_next, isa_next, h, n,
           lh: int, R: int):
    """Class grouping (ref :594-603, match.h:27-33); transcription of
    device_merge.group_dev."""
    idx = gidx64(lh)
    G = lh * R
    valid = idx < h
    scale = n + 1
    pk_li = jnp.where(valid, ln * scale + isa_next, BIG)
    key1 = jnp.where(valid, pos, BIG)
    (k_p, k_li), (order, ln_s, isa_s) = dsort(
        [key1, pk_li], [idx, ln, isa_next], lh, R, BIG)
    prev_p = dshift(k_p, I64(-1), I64(-1), lh, R)
    prev_li = dshift(k_li, I64(-1), I64(-1), lh, R)
    valid_s = idx < h
    new_grp = (k_p != prev_p) | (k_li != prev_li)
    firsts = new_grp & valid_s
    n_classes = _tot(firsts.astype(I64))
    gid = dcumsum(firsts.astype(I64), R) - 1
    # compact class firsts
    ckey = jnp.where(firsts, idx, BIG)
    _, (fi, cls_pos, cls_len, cls_isa, first_head) = dsort(
        [ckey], [idx, k_p, ln_s, isa_s, order], lh, R, BIG)
    cvalid = idx < n_classes
    cls_smaller = jnp.where(
        cvalid, dgather(smaller.astype(I64), first_head, I64(0), lh, R),
        0) != 0
    cls_until = jnp.where(
        cvalid, dgather(to_next, first_head, I64(0), lh, R), 0)
    fi_nxt = dshift(fi, I64(1), I64(0), lh, R)
    cls_size = jnp.where(
        cvalid, jnp.where(idx + 1 < n_classes, fi_nxt, h) - fi, 0)
    key_k = jnp.where(cls_smaller, cls_len, 2 * n - cls_len)
    key_k = jnp.where(cvalid, key_k, BIG)

    # text order (pos, K, isaNext)
    pk_ki = jnp.where(cvalid, key_k * scale + cls_isa, BIG)
    cpos_key = jnp.where(cvalid, cls_pos, BIG)
    (tpos, tki), (torder, tlen, tisa, tsml, tuntil, tsize, tkk) = dsort(
        [cpos_key, pk_ki],
        [idx, cls_len, cls_isa, cls_smaller.astype(I64), cls_until,
         cls_size, key_k], lh, R, BIG)
    # rank of each grouped-order class in text order
    _, (text_rank,) = dsort([jnp.where(idx < n_classes, torder, BIG)],
                            [idx], lh, R, BIG)
    # members regrouped by text-ordered class (stable keeps idx order)
    mkey = jnp.where(valid_s,
                     dgather(text_rank, jnp.clip(gid, 0, G - 1), I64(0),
                             lh, R), BIG)
    _, (member_head,) = dsort([mkey], [order], lh, R, BIG)
    member_off = dcumsum(tsize, R) - tsize
    return dict(n_classes=n_classes, pos=tpos, length=tlen, isa_next=tisa,
                smaller=tsml != 0, until_next=tuntil, size=tsize,
                key_k=tkk, member_head=member_head, member_off=member_off)


def _class_ranks(cls, ref_isa, h, d, n, lh: int, ln_: int, R: int):
    """rankToHead + SA-walk class order (ref :627-645); transcription of
    device_merge.class_ranks_dev."""
    idx = gidx64(lh)
    G = lh * R
    cvalid = idx < cls["n_classes"]
    isa_pos = jnp.where(
        cvalid, dgather(ref_isa, jnp.clip(cls["pos"], 0, ln_ * R - 1),
                        I64(0), ln_, R), BIG)
    pk = jnp.where(cvalid, cls["key_k"] * (n + 1) + cls["isa_next"], BIG)
    _, (sa_ord,) = dsort([isa_pos, pk], [idx], lh, R, BIG)
    rank_value = dscatter(jnp.zeros(lh, I64),
                          jnp.where(cvalid, sa_ord, I64(-1)),
                          jnp.where(cvalid, idx + d, 0), lh, R, mode="set")
    pseudo_cls = _bcast0(sa_ord)
    mvalid = idx < h
    starts = dscatter(
        jnp.zeros(lh, I64),
        jnp.where(cvalid & (cls["size"] > 0), cls["member_off"], I64(-1)),
        idx + 1, lh, R, mode="max")
    cls_of_slot = dcummax(starts, R) - 1
    within = idx - dgather(cls["member_off"],
                           jnp.clip(cls_of_slot, 0, G - 1), I64(0), lh, R)
    is_pseudo = cls_of_slot == pseudo_cls
    mrank = jnp.where(is_pseudo, 1 + within,
                      dgather(rank_value, jnp.clip(cls_of_slot, 0, G - 1),
                              I64(0), lh, R))
    mrank = jnp.where(mvalid, mrank, 0)
    rank_to_head = dscatter(jnp.zeros(lh, I64),
                            jnp.where(mvalid, cls["member_head"], I64(-1)),
                            mrank, lh, R, mode="set")
    # terminator slot h keeps 0 (zeros base; member_head < h)
    return rank_to_head, sa_ord, cls_of_slot


# ---------------------------------------------------------------------------
# Stage 3b: head-string suffix sort (ref :648, libsais_int) over the mesh
# ---------------------------------------------------------------------------

def _dist_suffix_sort(s_vals, length, lh: int, R: int, rounds: int):
    """ISA of the integer string s (rows >= length get distinct ascending
    symbols above every real one, so they resolve immediately and sort to
    the top — same convention as device_merge.head_string_sa_dev).

    Early convergence: once every rank is distinct
    the string is fully sorted, and the remaining doubling rounds are
    skipped via lax.cond on a REPLICATED done flag (derived from a psum,
    so every shard takes the same branch and the collective schedules
    stay consistent). Head rank strings resolve in a handful of rounds —
    the old fixed ceil(log2(G)) schedule ran ~20."""
    idx = gidx64(lh)
    G = lh * R
    sym = jnp.where(idx < length, s_vals, BIG // 2 + idx)

    # initial rank by symbol: sort, boundary, global prefix
    def rerank(k1, k2):
        (m1, m2), (mi,) = dsort([k1, k2], [idx], lh, R, BIG)
        p1 = dshift(m1, I64(-1), I64(-7), lh, R)
        p2 = dshift(m2, I64(-1), I64(-7), lh, R)
        changed = (m1 != p1) | (m2 != p2)
        ndist = _tot(changed.astype(I64))
        r = dcumsum(changed.astype(I64), R) - 1
        return dscatter(jnp.zeros(lh, I64), mi, r, lh, R,
                        mode="set"), ndist

    rank, ndist0 = rerank(sym, jnp.zeros(lh, I64))

    # exchange overflow flags born inside the scan body must not leak to
    # the outer trace (dist.py capacity contract): each round collects its
    # own flags into the scan carry; the reduced flag is re-noted outside
    def round_k(carry, k):
        rank, done, ovf = carry

        def work(args):
            rank, ovf = args
            w = I64(1) << k
            with D.overflow_scope() as flags:
                nxt = dshift(rank, w, I64(-1), lh, R)
                out, ndist = rerank(rank, nxt)
                ovf = ovf | D.overflow_any(flags)
            return out, ndist, ovf

        def skip(args):
            rank, ovf = args
            return rank, I64(G), ovf

        rank, ndist, ovf = jax.lax.cond(done, skip, work, (rank, ovf))
        return (rank, done | (ndist >= G), ovf), None

    (rank, _, ovf), _ = jax.lax.scan(
        round_k, (rank, ndist0 >= G, jnp.zeros((), I64)),
        jnp.arange(rounds, dtype=jnp.int64))
    D._note_overflow(ovf != 0)
    return rank  # ISA over the padded domain


def _head_string_sa(rank_to_head, h, lh: int, R: int, rounds: int):
    """head_to_rank: SA of the rank string compacted to the real suffixes
    (first h+1 entries real; ref :648-665)."""
    idx = gidx64(lh)
    isa = _dist_suffix_sort(rank_to_head, h + 1, lh, R, rounds)
    sa = dscatter(jnp.zeros(lh, I64), isa, idx, lh, R, mode="set")
    key = jnp.where(sa <= h, idx, BIG)
    _, (head_to_rank,) = dsort([key], [sa], lh, R, BIG)
    return head_to_rank


def _rank_heads(cls, head_to_rank, char, succ, h, lh: int, R: int):
    """final ranks, head BWT, successor re-rank (ref :661-687);
    transcription of device_merge.rank_heads_dev."""
    idx = gidx64(lh)
    G = lh * R
    valid = idx < h
    sa_body = dshift(head_to_rank, I64(1), I64(0), lh, R)
    final_rank = dscatter(jnp.zeros(lh, I64),
                          jnp.where(valid, sa_body, I64(-1)), idx,
                          lh, R, mode="set")
    bwt_heads = dgather(char, jnp.clip(sa_body, 0, G - 1), I64(0), lh, R)
    succ_rank = dgather(final_rank, jnp.clip(succ, 0, G - 1), I64(0),
                        lh, R)
    member_rank = dgather(succ_rank,
                          jnp.clip(cls["member_head"], 0, G - 1), I64(0),
                          lh, R)
    W = I64(G + 2)
    pk = jnp.where(valid, cls["cls_of_slot"] * W + member_rank, BIG)
    _, (member_rank_sorted,) = dsort([pk], [member_rank], lh, R, BIG)
    return final_rank, bwt_heads, succ_rank, member_rank_sorted


# ---------------------------------------------------------------------------
# Stage 4: tail positioning (ref :1517-1603)
# ---------------------------------------------------------------------------

def _tail_pairs_count(cls, h, lh: int, R: int):
    """Buckets + per-class interesting-bucket ranges (transcription of
    device_merge.tail_pairs_count_dev)."""
    idx = gidx64(lh)
    G = lh * R
    cvalid = idx < cls["n_classes"]
    pos = cls["pos"]
    prev_pos = dshift(pos, I64(-1), I64(-5), lh, R)
    new_b = (pos != prev_pos) & cvalid
    n_buckets = _tot(new_b.astype(I64))
    bid = dcumsum(new_b.astype(I64), R) - 1
    bkey = jnp.where(new_b, idx, BIG)
    _, (bucket_pos, cls_lo) = dsort([bkey], [pos, idx], lh, R, BIG)
    bvalid = idx < n_buckets
    cls_lo_nxt = dshift(cls_lo, I64(1), I64(0), lh, R)
    cls_hi = jnp.where(
        bvalid,
        jnp.where(idx + 1 < n_buckets, cls_lo_nxt, cls["n_classes"]), 0)
    bp = jnp.where(bvalid, bucket_pos, BIG)
    lo = _lower_bound_join(bp, n_buckets,
                           jnp.where(cvalid, pos + 1, BIG), lh, R)
    hi = _lower_bound_join(bp, n_buckets,
                           jnp.where(cvalid, pos + cls["until_next"] + 1,
                                     BIG), lh, R)
    cnt = jnp.where(cvalid, jnp.maximum(hi - lo, 0), 0)
    total = _tot(cnt)
    return dict(bucket_pos=bucket_pos, n_buckets=n_buckets, cls_lo=cls_lo,
                cls_hi=cls_hi, bucket_of_class=bid, pair_lo=lo,
                pair_cnt=cnt, total=total)


def _lower_bound_join(sorted_vals, n_valid, queries, lh: int, R: int):
    """index of first sorted_vals[j] >= queries[i] over the mesh: one
    2*lh-per-shard dsort (targets + queries), reverse fill, route back."""
    idx = gidx64(lh)
    # key packs the tie flag low (queries sort before equal targets)
    tkey = jnp.where(sorted_vals < BIG, sorted_vals * 2 + 1, BIG)
    qkey = jnp.where(queries < BIG, queries * 2, BIG)
    keys = jnp.concatenate([tkey, qkey])
    srcidx = jnp.concatenate([idx, idx])
    flag = jnp.concatenate([jnp.ones(lh, I64), jnp.zeros(lh, I64)])
    lj = 2 * lh
    (k_s,), (i_s, f_s) = dsort([keys], [srcidx, flag], lj, R, BIG)
    tgt = dcummin_rev(jnp.where((f_s == 1) & (k_s < BIG), i_s,
                                BIG), R)
    qk2 = jnp.where((f_s == 0) & (k_s < BIG), i_s, BIG)
    _, (ans,) = dsort([qk2], [jnp.minimum(tgt, n_valid)], lj, R, BIG)
    # first lh*R rows of the sorted order are the queries in idx order —
    # but the result domain is 2*lh per shard; slice back to lh per shard
    return _shrink_half(ans, lh, R)


def _shrink_half(vals, lh: int, R: int):
    """(2*lh,)-per-shard regular layout -> (lh,) regular layout keeping
    global rows [0, lh*R) (one routed exchange)."""
    idx2 = gidx64(2 * lh)
    out = dscatter(jnp.zeros(lh, vals.dtype),
                   jnp.where(idx2 < lh * R, idx2, I64(-1)), vals,
                   lh, R, mode="set")
    return out


def _grow_concat(a, b, lh: int, lp: int, R: int, fill_a, fill_b):
    """Two regular-layout domains (lh,), (lp,) -> one (lh+lp,) regular
    domain: global rows [0, G_H) = a, [G_H, G_H + G_P) = b."""
    G_H = lh * R
    idx_j = gidx64(lh + lp)
    a_full = dgather(a, jnp.where(idx_j < G_H, idx_j, I64(-1)), fill_a,
                     lh, R)
    b_full = dgather(b, jnp.where(idx_j >= G_H, idx_j - G_H, I64(-1)),
                     fill_b, lp, R)
    return jnp.where(idx_j < G_H, a_full, b_full)


def _tail_good(cls, pairs, slot_base, h, n, lh: int, lp: int, R: int):
    """Expand (class, bucket) pairs, lower_bound each query key in its
    bucket via one global sorted join, credit the good path
    (transcription of device_merge.tail_good_dev; the join dsort's bucket
    exchange is the all-to-all tail reshard of ref :1517-1603)."""
    idx_h = gidx64(lh)
    idx_p = gidx64(lp)
    G_H = lh * R
    cvalid = idx_h < cls["n_classes"]
    cnt = pairs["pair_cnt"]
    off = dcumsum(cnt, R) - cnt
    total = pairs["total"]
    pvalid = idx_p < total
    # segment-expand src class + attributes (P domain): FIVE packed
    # scatter+cummax fills with SHARED scatter rows — one routed
    # multi-channel scatter + one row-wise cummax instead of five of
    # each (the device merge's (5, P) shared-index fill, mesh form:
    # the bucket-offset argsorts, the index all_to_all, and the
    # shard-prefix exchanges are paid once)
    live_c = cvalid & (cnt > 0)
    M33 = (I64(1) << 33) - 1
    pay5 = jnp.stack([
        idx_h + 1,
        pairs["pair_lo"] - off + lp * R,
        ((cls["length"] + cls["pos"]) << 1) | cls["smaller"].astype(I64),
        cls["isa_next"],
        cls["size"],
    ])
    base5 = dscatter_rows(jnp.full((5, lp), -1, I64),
                          jnp.where(live_c, off, I64(-1)),
                          ((off + 1) << 33)[None, :] | pay5,
                          lp, R, mode="max")
    filled5 = dcummax_rows(base5, R) & M33
    # every live pair row (idx_p < total) is at-or-after the first class
    # start (off 0), so the clip only touches dead rows (as before)
    src_cls = jnp.clip(filled5[0] - 1, 0, G_H - 1)
    delta1 = filled5[1]
    b_idx = idx_p + delta1 - lp * R
    b = dgather(pairs["bucket_pos"], jnp.clip(b_idx, 0, G_H - 1), I64(0),
                lh, R)
    s1s = filled5[2]
    q_len = (s1s >> 1) - b
    q_small = (s1s & 1) != 0
    q_isa = filled5[3]
    q_size = filled5[4]
    q_k = jnp.where(q_small, q_len, 2 * n - q_len)

    scale = n + 1
    t_k2 = jnp.where(cvalid, cls["key_k"] * scale + cls["isa_next"], BIG)
    q_k2 = jnp.where(pvalid, q_k * scale + q_isa, BIG)
    key1 = jnp.concatenate([jnp.where(cvalid, cls["pos"], BIG),
                            jnp.where(pvalid, b, BIG)])
    key2f = jnp.concatenate([jnp.where(cvalid, (t_k2 << 1) | 1, BIG),
                             jnp.where(pvalid, q_k2 << 1, BIG)])
    srcidx = jnp.concatenate([idx_h, idx_p])
    pay = jnp.concatenate([slot_base, q_size])
    lj = lh + lp
    (k1s, k2fs), (i_s, pay_s) = dsort([key1, key2f], [srcidx, pay],
                                      lj, R, BIG)
    f_s = (k2fs & 1).astype(I64)
    f_s = jnp.where(k2fs >= BIG, 2, f_s)  # pads are neither side
    k2s = k2fs >> 1
    rows = gidx64(lj)
    G_J = lj * R

    LOW34 = (I64(1) << 34) - 1

    def rev_fill(payload34):
        packed = jnp.where(f_s == 1, (rows << 34) | payload34, BIG)
        return dcummin_rev(packed, R)

    fp = rev_fill(jnp.clip(k1s, 0, LOW34))
    f_pos = fp & LOW34
    t_row = fp >> 34
    f_cls = dcummin_rev(jnp.where(f_s == 1, (rows << 34) | i_s, BIG),
                        R) & LOW34
    k1_nxt = dshift(k1s, I64(1), I64(-3), lj, R)
    k2_nxt = dshift(k2s, I64(1), I64(-3), lj, R)
    change_next = (k1_nxt != k1s) | (k2_nxt != k2s)
    run_end = dcummin_rev(jnp.where(change_next, rows, I64(G_J)), R)
    is_q = f_s == 0
    in_range_s = is_q & (f_pos == jnp.clip(k1s, 0, LOW34)) & (k1s < BIG)
    exact_s = in_range_s & (t_row <= run_end)
    good_s = in_range_s & ~exact_s
    # good credit: cumsum difference at unique target rows
    gcum = dcumsum(jnp.where(good_s, pay_s, 0), R)
    prev_t = dshift(
        dcummax(jnp.where(f_s == 1, rows, I64(-1)), R),
        I64(-1), I64(-1), lj, R)
    base_cum = jnp.where(prev_t >= 0,
                         dgather(gcum, jnp.clip(prev_t, 0, G_J - 1),
                                 I64(0), lj, R), 0)
    credit = gcum - base_cum
    is_t = f_s == 1
    counter = dscatter(jnp.zeros(lh, I64),
                       jnp.where(is_t, pay_s, I64(-1)),
                       jnp.where(is_t, credit, 0), lh, R, mode="add")
    n_exact = _tot(exact_s.astype(I64))
    exact_members = _tot(jnp.where(exact_s, pay_s, 0))
    # compact exact pairs (pair idx, found class) back into the P domain
    ekey = jnp.where(exact_s, i_s, BIG)
    _, (e_pidx, e_fnd) = dsort([ekey], [i_s, f_cls], lj, R, BIG)
    e_pidx = _shrink_to(e_pidx, lj, lp, R)
    e_fnd = _shrink_to(e_fnd, lj, lp, R)
    return (counter, n_exact, exact_members, e_pidx, e_fnd, src_cls)


def _shrink_to(vals, lsrc: int, ldst: int, R: int):
    """(lsrc,)-per-shard regular layout -> (ldst,) regular layout keeping
    global rows [0, ldst*R)."""
    idx = gidx64(lsrc)
    return dscatter(jnp.zeros(ldst, vals.dtype),
                    jnp.where(idx < ldst * R, idx, I64(-1)), vals,
                    ldst, R, mode="set")


def _tail_exact(cls, pairs, slot_base, member_rank_sorted, cls_of_slot,
                e_pidx, e_fnd, src_cls, n_exact, h,
                lh: int, lp: int, lm: int, R: int):
    """Exact-key (counterBad) member-merge path (ref :1567-1589);
    transcription of device_merge.tail_exact_dev."""
    idx_e = gidx64(lp)
    idx_m = gidx64(lm)
    G_H = lh * R
    evalid = idx_e < n_exact
    e_src = dgather(src_cls, jnp.clip(e_pidx, 0, lp * R - 1), I64(0),
                    lp, R)
    msz = jnp.where(evalid,
                    dgather(cls["size"], jnp.clip(e_src, 0, G_H - 1),
                            I64(0), lh, R), 0)
    off = dcumsum(msz, R) - msz
    tot = _tot(msz)
    mvalid = idx_m < tot
    starts = dscatter(jnp.zeros(lm, I64),
                      jnp.where(evalid & (msz > 0), off, I64(-1)),
                      idx_e + 1, lm, R, mode="max")
    pair_of = jnp.clip(dcummax(starts, R) - 1, 0, lp * R - 1)
    within = idx_m - dgather(off, pair_of, I64(0), lp, R)
    src = dgather(e_src, pair_of, I64(0), lp, R)
    dst = dgather(e_fnd, pair_of, I64(0), lp, R)
    sb_src = dgather(slot_base, jnp.clip(src, 0, G_H - 1), I64(0), lh, R)
    q = dgather(member_rank_sorted,
                jnp.clip(sb_src + within, 0, G_H - 1), I64(0), lh, R)
    # upper_bound join: targets (class-of-slot, member_rank, slot) vs
    # queries (dst, q); equal targets sort BEFORE the query
    hvalid = gidx64(lh) < h
    W = I64(G_H + 2)
    tkey = jnp.where(hvalid, cls_of_slot * W * 4 + member_rank_sorted * 4
                     + 1, BIG)
    qkey = jnp.where(mvalid, dst * W * 4 + q * 4 + 2, BIG)
    keys = jnp.concatenate([tkey, qkey])
    srcidx = jnp.concatenate([gidx64(lh), idx_m])
    flag = jnp.concatenate([jnp.ones(lh, I64), jnp.zeros(lm, I64)])
    lj = lh + lm
    (k_s,), (i_s, f_s) = dsort([keys], [srcidx, flag], lj, R, BIG)
    tgt = dcummin_rev(jnp.where((f_s == 1) & (k_s < BIG), i_s, BIG), R)
    qk2 = jnp.where((f_s == 0) & (k_s < BIG), i_s, BIG)
    _, (p_slot_j,) = dsort([qk2], [jnp.clip(tgt, 0, G_H - 1)], lj, R, BIG)
    p_slot = _shrink_to(p_slot_j, lj, lm, R)
    cls_at = dgather(cls_of_slot, jnp.clip(p_slot, 0, G_H - 1), I64(-1),
                     lh, R)
    inb = mvalid & (cls_at == dst)
    counter = dscatter(jnp.zeros(lh, I64),
                       jnp.where(inb, p_slot, I64(-1)),
                       jnp.ones(lm, I64), lh, R, mode="add")
    boc = dgather(pairs["bucket_of_class"], jnp.clip(dst, 0, G_H - 1),
                  I64(0), lh, R)
    chi = dgather(pairs["cls_hi"], jnp.clip(boc, 0, G_H - 1), I64(0),
                  lh, R)
    has_next = (dst + 1) < chi
    spill_ok = mvalid & ~inb & has_next
    sb_next = dgather(slot_base, jnp.clip(dst + 1, 0, G_H - 1), I64(0),
                      lh, R)
    counter = dscatter(counter, jnp.where(spill_ok, sb_next, I64(-1)),
                       jnp.ones(lm, I64), lh, R, mode="add")
    return counter


# ---------------------------------------------------------------------------
# Stage 5: run assembly (ref :939-1085 / :1630-1777)
# ---------------------------------------------------------------------------

def _runs_emit(cls, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
               ref_sa, ref_isa, ref_bwt, d, n, h,
               lh: int, ln_: int, R: int, rle_quirk: bool):
    """Sorted-emission run assembly (transcription of
    device_merge.runs_emit_dev); returns the merged global run list in the
    lane domain (len, char, n_runs)."""
    idx_h = gidx64(lh)
    idx_n = gidx64(ln_)
    G_H = lh * R
    G_N = ln_ * R
    nec = cls["n_classes"] - 1
    evalid = idx_h < nec
    ecls = jnp.clip(dshift(sa_ord, I64(1), I64(0), lh, R), 0, G_H - 1)
    m_c = jnp.where(evalid, dgather(cls["size"], ecls, I64(0), lh, R), 0)
    cls_pos_e = dgather(cls["pos"], ecls, I64(0), lh, R)
    bucket_rank = jnp.where(
        evalid, dgather(ref_isa, jnp.clip(cls_pos_e, 0, G_N - 1), I64(0),
                        ln_, R), BIG)
    prev_br = dshift(bucket_rank, I64(-1), I64(-9), lh, R)
    new_b = (bucket_rank != prev_br) & evalid
    bid = dcumsum(new_b.astype(I64), R) - 1
    # per-rank run counts (N domain)
    hb_at = dscatter(jnp.zeros(ln_, I64),
                     jnp.where(evalid, bucket_rank, I64(-1)), m_c,
                     ln_, R, mode="add")
    ncls_at = dscatter(jnp.zeros(ln_, I64),
                       jnp.where(evalid, bucket_rank, I64(-1)),
                       jnp.ones(lh, I64), ln_, R, mode="add")
    extra = 2 * hb_at + (ncls_at if rle_quirk
                         else jnp.minimum(ncls_at, 1)) - \
        jnp.minimum(ncls_at, 1)
    rank_valid = (idx_n >= 1) & (idx_n < n)
    runs_per_rank = jnp.where(rank_valid, 1 + extra, 0)
    offsets = (dcumsum(runs_per_rank, R) - runs_per_rank) + (d - 1)

    # --- lane sources ---
    # A: prelude BWTheads[0..D-2]
    a_off = idx_h
    a_len = jnp.where(idx_h < d - 1, 1, 0)
    a_chr = bwt_heads
    # B: simple buckets
    simple = rank_valid & (extra == 0)
    b_len0 = dgather(tails_cnt, jnp.clip(ref_sa, 0, G_N - 1), I64(0),
                     ln_, R)
    b_off = offsets
    b_len = jnp.where(simple, b_len0, 0)
    b_chr = ref_bwt
    # class-level geometry
    bchar = dgather(ref_bwt,
                    jnp.clip(bucket_rank, 0, G_N - 1), I64(0), ln_, R)
    first_of_b = dscatter(jnp.zeros(lh, I64),
                          jnp.where(new_b, bid, I64(-1)), idx_h,
                          lh, R, mode="set")
    k_c = idx_h - dgather(first_of_b, jnp.clip(bid, 0, G_H - 1), I64(0),
                          lh, R)
    ex_mc = dcumsum(m_c, R) - m_c
    mc_first = dscatter(jnp.zeros(lh, I64),
                        jnp.where(new_b, bid, I64(-1)), ex_mc,
                        lh, R, mode="set")
    mc_before = ex_mc - dgather(mc_first, jnp.clip(bid, 0, G_H - 1),
                                I64(0), lh, R)
    off_at_br = dgather(offsets, jnp.clip(bucket_rank, 0, G_N - 1),
                        I64(0), ln_, R)
    cls_start = off_at_br + 2 * mc_before + (k_c if rle_quirk else 0)
    # C/D: per member slot
    tot_slots = _tot(m_c)
    mvalid = idx_h < tot_slots
    base_c = dgather(slot_base, ecls, I64(0), lh, R)
    cstart = dscatter(jnp.zeros(lh, I64),
                      jnp.where(evalid & (m_c > 0), ex_mc, I64(-1)),
                      idx_h + 1, lh, R, mode="max")
    cls_of = jnp.clip(dcummax(cstart, R) - 1, 0, G_H - 1)
    within = idx_h - dgather(ex_mc, cls_of, I64(0), lh, R)
    slot_text = jnp.clip(dgather(base_c, cls_of, I64(0), lh, R) + within,
                         0, G_H - 1)
    rt = dgather(cls_start, cls_of, I64(0), lh, R) + 2 * within
    cnt_slot = dgather(counter, slot_text, I64(0), lh, R)
    c_off = rt
    c_len = jnp.where(mvalid, cnt_slot, 0)
    c_chr = dgather(bchar, cls_of, I64(0), lh, R)
    d_off = rt + 1
    d_len = jnp.where(mvalid, 1, 0)
    d_chr = dgather(bwt_heads, jnp.clip(d - 1 + idx_h, 0, G_H - 1),
                    I64(0), lh, R)
    # E: residuals
    ccnt = dcumsum(jnp.where(mvalid, cnt_slot, 0), R)
    csum_hi = dgather(ccnt, jnp.clip(ex_mc + m_c - 1, 0, G_H - 1),
                      I64(0), lh, R)
    csum_lo = jnp.where(
        ex_mc > 0,
        dgather(ccnt, jnp.clip(ex_mc - 1, 0, G_H - 1), I64(0), lh, R), 0)
    csum_c = jnp.where(evalid & (m_c > 0), csum_hi - csum_lo, 0)
    inc = csum_c + m_c
    cum_inc = dcumsum(inc, R)
    cum_exc_first = dscatter(jnp.zeros(lh, I64),
                             jnp.where(new_b, bid, I64(-1)),
                             cum_inc - inc, lh, R, mode="set")
    cum_inc_b = cum_inc - dgather(cum_exc_first,
                                  jnp.clip(bid, 0, G_H - 1), I64(0),
                                  lh, R)
    hb_b = dscatter(jnp.zeros(lh, I64), jnp.where(evalid, bid, I64(-1)),
                    m_c, lh, R, mode="add")
    sa_at_br = dgather(ref_sa, jnp.clip(bucket_rank, 0, G_N - 1), I64(0),
                       ln_, R)
    b_total = dgather(hb_b, jnp.clip(bid, 0, G_H - 1), I64(0), lh, R) + \
        dgather(tails_cnt, jnp.clip(sa_at_br, 0, G_N - 1), I64(0), ln_, R)
    if rle_quirk:
        e_valid = evalid
        e_off = cls_start + 2 * m_c
    else:
        nb_nxt = dshift(new_b.astype(I64), I64(1), I64(0), lh, R)
        is_last_of_b = (nb_nxt != 0) | (idx_h + 1 == nec)
        e_valid = evalid & is_last_of_b
        hb_c = dgather(hb_b, jnp.clip(bid, 0, G_H - 1), I64(0), lh, R)
        e_off = off_at_br + 2 * hb_c
    e_len = jnp.where(e_valid, b_total - cum_inc_b, 0)
    e_chr = bchar

    off = jnp.concatenate([a_off, b_off, c_off, d_off, e_off])
    lens = jnp.concatenate([a_len, b_len, c_len, d_len, e_len])
    chars = jnp.concatenate([a_chr, b_chr, c_chr, d_chr, e_chr])
    le = 4 * lh + ln_
    key = jnp.where(lens > 0, off, BIG)
    (k_s,), (len_s, chr_s) = dsort([key], [lens, chars], le, R, BIG)
    rows = gidx64(le)
    valid_s = (k_s < BIG) & (len_s > 0)
    prv_chr = dshift(chr_s, I64(-1), I64(-1), le, R)
    prv_val = dshift(valid_s.astype(I64), I64(-1), I64(0), le, R) != 0
    nxt_chr = dshift(chr_s, I64(1), I64(-1), le, R)
    nxt_val = dshift(valid_s.astype(I64), I64(1), I64(0), le, R) != 0
    new_g = valid_s & (~prv_val | (prv_chr != chr_s))
    is_last = valid_s & (~nxt_val | (nxt_chr != chr_s))
    cum = dcumsum(len_s, R)
    exc = cum - len_s
    packedg = jnp.where(new_g, (rows << 40) | exc, I64(-1))
    fe = dcummax(packedg, R) & ((I64(1) << 40) - 1)
    lenm = jnp.where(is_last, cum - fe, 0)
    n_runs = _tot(is_last.astype(I64))
    key2 = jnp.where(is_last, rows, BIG)
    _, (rl, rc) = dsort([key2], [lenm, chr_s], le, R, BIG)
    # 1-byte packed form + globally compacted big-run overflow (the
    # device merge's download scheme, device_merge.runs_emit_dev): runs
    # with len < 64 and an ACGT char ship as 6-bit len + 2-bit code; the
    # rest ride a (global idx, len<<8|char) list dsort-compacted to the
    # global front. Host fetches geometric prefixes (tier slicing happens
    # per-shard in _stage_runs).
    rvalid = rows < n_runs
    code = ((rc == 67).astype(I64) + 2 * (rc == 71).astype(I64)
            + 3 * (rc == 84).astype(I64))
    is_acgt = (rc == 65) | (rc == 67) | (rc == 71) | (rc == 84)
    big = rvalid & ((rl >= 64) | ~is_acgt)
    n_big = _tot(big.astype(I64))
    packed8 = jnp.where(big | ~rvalid, 0,
                        (rl << 2) | code).astype(jnp.uint8)
    (bkey,), (bpay,) = dsort([jnp.where(big, rows, BIG)],
                             [(rl << 8) | rc], le, R, BIG)
    return rl, rc, n_runs, packed8, bkey, bpay, n_big


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def _spec(mesh, *arrs):
    return [jax.device_put(a, NamedSharding(mesh, P(AXIS))) for a in arrs]


_CF_MEMO: dict = {}  # mesh size -> last clean capacity factor


def merge_heads_sharded(head_t, head_pos, head_len, head_smaller,
                        head_char, ref_sa, ref_isa, ref_bwt,
                        h: int, n: int, sn: int, d: int, rle_quirk: bool,
                        n_devices: int | None = None):
    """Full downstream merge over the mesh; numpy head records (stream
    order) + reference index in, (run_len, run_char) numpy out.

    Every sort/join runs as a mesh sample-sort (all-to-all reshard), every
    scan as a local scan + shard-prefix exchange; slot counters accumulate
    by routed scatter-add; the final run list downloads one shard-slice
    per device. Byte-equal to engine/device_merge.merge_heads_numpy."""
    import os as _os
    mesh = D.make_mesh(n_devices)
    R = int(mesh.devices.size)
    lh = -(-max(h + 2, 16) // R)
    ln_ = -(-max(n + 2, 16) // R)
    # capacity factor: env default, raised to the last factor that ran
    # clean at this mesh size — an overflow retry re-runs whole stage
    # programs AND invalidates their prewarmed compiles, so remembering
    # the working factor pays twice on repeat runs
    cf = max(int(_os.environ.get("CMSBWT_SHARD_CAP_FACTOR", "4")),
             _CF_MEMO.get(R, 0))
    with jax.enable_x64(True):
        if isinstance(head_t, jax.Array):
            # device-resident inputs (DeviceHeadsResult): cast/pad on the
            # chip and reshard — nothing O(n + H) crosses the host link
            args = [D.shard_dev(mesh, a, lh, h)
                    for a in (head_t, head_pos, head_len, head_smaller,
                              head_char)] + \
                   [D.shard_dev(mesh, a, ln_, n)
                    for a in (ref_sa, ref_isa, ref_bwt)]
        else:
            args = [
                D.shard(mesh, np.asarray(head_t, np.int64)[:h], 0, lh),
                D.shard(mesh, np.asarray(head_pos, np.int64)[:h], 0, lh),
                D.shard(mesh, np.asarray(head_len, np.int64)[:h], 0, lh),
                D.shard(mesh, np.asarray(head_smaller, np.int64)[:h], 0,
                        lh),
                D.shard(mesh, np.asarray(head_char, np.int64)[:h], 0, lh),
                D.shard(mesh, np.asarray(ref_sa, np.int64)[:n], 0, ln_),
                D.shard(mesh, np.asarray(ref_isa, np.int64)[:n], 0, ln_),
                D.shard(mesh, np.asarray(ref_bwt, np.int64)[:n], 0, ln_),
            ]
        # replicated over the mesh, as the prewarm lowers it: a scalar
        # vector left on one device lowers to a different program, and the
        # dispatch would compile stage A a second time
        scal = jax.device_put(jnp.asarray([h, n, sn, d], jnp.int64),
                              NamedSharding(mesh, P()))
        rounds = 1
        while (1 << rounds) < max(lh * R, 2):
            rounds += 1

        # prewarm: stage A and the runs stage have
        # shapes fully known at entry — compile them concurrently on the
        # background threads while the uploads land (the pair-dependent
        # good/exact stages stay dispatch-compiled; their shapes need
        # total_pairs). The cap factor reaches the trace through the
        # D.set_cap_factor call INSIDE each program, so the prewarm
        # thread traces the same exchange grids the dispatch will use.
        from ..utils import prewarm as _pw
        wave = _pw.Wave()
        cfa0 = None if cf >= R else cf
        if _pw.enabled():
            import jax as _j
            NS = NamedSharding(mesh, P(AXIS))
            NS2 = NamedSharding(mesh, P(None, AXIS))
            NSr = NamedSharding(mesh, P())
            GH, GN = lh * R, ln_ * R
            hv = lambda: _j.ShapeDtypeStruct((GH,), jnp.int64, sharding=NS)
            nv = lambda: _j.ShapeDtypeStruct((GN,), jnp.int64, sharding=NS)
            sc = _j.ShapeDtypeStruct((4,), jnp.int64, sharding=NSr)
            wave.add("stage_a", _stage_a_program, mesh, hv(), hv(), hv(),
                     hv(), hv(), nv(), nv(), nv(), sc, x64=True,
                     lh=lh, ln_=ln_, R=R, rounds=rounds, cap_factor=cfa0)
            wave.add("stage_runs", _stage_runs, mesh,
                     _j.ShapeDtypeStruct((len(CLS_KEYS), GH), jnp.int64,
                                         sharding=NS2),
                     hv(), hv(), hv(), nv(), hv(), nv(), nv(), nv(), sc,
                     x64=True, lh=lh, ln_=ln_, R=R,
                     rle_quirk=bool(rle_quirk), cap_factor=cfa0)

        # capacity-bounded exchanges with overflow retry (parallel/dist.py
        # capacity contract): a doubled factor re-runs the merge; factor
        # >= R is exactly the old full-local grid, so the chain terminates
        from ..ops.ms_dense import _stage_timer
        mark = _stage_timer()
        while True:
            cfa = None if cf >= R else cf
            if cfa == cfa0:
                wave.ready("stage_a")
            (cls_stack, pairs_stack, meta_sh, member_rank_sorted,
             cls_of_slot, sa_ord, bwt_heads, tails_cnt,
             slot_base) = _stage_a_program(
                mesh, *args, scal, lh=lh, ln_=ln_, R=R, rounds=rounds,
                cap_factor=cfa)
            meta_np = _gg(meta_sh)[:4]
            mark("shm_stage_a(cf=%s)" % cfa)
            if int(meta_np[3]):
                cf *= 2
                continue
            meta = jnp.asarray(meta_np[:3])  # replicated copy
            total_pairs = int(meta_np[2])
            lp = -(-max(total_pairs, 16) // R)
            (counter, stats_sh, e_pidx, e_fnd,
             src_cls) = _stage_good_program(
                mesh, cls_stack, pairs_stack, slot_base, meta, scal,
                lh=lh, lp=lp, R=R, cap_factor=cfa)
            stats_np = _gg(stats_sh)[:3]
            mark("shm_stage_good")
            if int(stats_np[2]):
                cf *= 2
                continue
            n_exact = int(stats_np[0])
            exact_members = int(stats_np[1])
            if n_exact:
                lm = -(-max(exact_members, 16) // R)
                counter2, eovf_sh = _stage_exact(
                    mesh, cls_stack, pairs_stack, slot_base,
                    member_rank_sorted, cls_of_slot, e_pidx, e_fnd,
                    src_cls, jnp.asarray([n_exact, h], jnp.int64),
                    lh=lh, lp=lp, lm=lm, R=R, cap_factor=cfa)
                mark("shm_stage_exact")
                if int(_gg(eovf_sh)[0]):
                    cf *= 2
                    continue
                counter = counter + counter2
            if cfa == cfa0:
                wave.ready("stage_runs")
            rl, rc, n_runs_sh, p8_tiers, big_tiers = _stage_runs(
                mesh, cls_stack, sa_ord, slot_base, counter,
                tails_cnt, bwt_heads, args[5], args[6], args[7], scal,
                lh=lh, ln_=ln_, R=R, rle_quirk=bool(rle_quirk),
                cap_factor=cfa)
            nr_np = _gg(n_runs_sh)[:3]
            mark("shm_stage_runs")
            if int(nr_np[1]):
                cf *= 2
                continue
            n_runs = int(nr_np[0])
            n_big = int(nr_np[2])
            _CF_MEMO[R] = cf
            break
        # packed tier download (device_merge download scheme): tier t
        # carries each shard's first t local rows; shard s of the run
        # list owns global rows [s*le, (s+1)*le)
        from ..engine.device_merge import _ACGT, _big_tier_sizes, \
            _p8_tier_sizes
        le = 4 * lh + ln_
        big_cap = min(le, max(1024, le >> 6))
        bts = _big_tier_sizes(big_cap)
        bt_cap = bts[0]
        if n_big <= bt_cap:
            need0 = min(le, n_runs)  # shard 0 carries the largest prefix
            t_sizes = _p8_tier_sizes(le)
            t = t_sizes[0]
            for ts_ in t_sizes:
                if ts_ >= need0:
                    t = ts_
            p_np = _gg(p8_tiers[t_sizes.index(t)])
            parts = [p_np[s * t: s * t + max(
                0, min(n_runs - s * le, t))] for s in range(R)]
            p_all = np.concatenate(parts) if R > 1 else \
                p_np[:min(n_runs, t)]
            run_len = (p_all >> 2).astype(np.int64)
            run_char = _ACGT[p_all & 3]
            if n_big:
                bt = bt_cap
                for ts_ in bts:
                    if ts_ >= n_big:
                        bt = ts_
                bi = bts.index(bt)
                # big rows are global-front-compacted: shard 0's prefix
                bk = _gg(big_tiers[bi][0])[:n_big]
                bp = _gg(big_tiers[bi][1])[:n_big]
                run_len[bk] = bp >> 8
                run_char[bk] = (bp & 255).astype(np.uint8)
        else:  # rare: too many big runs for the overflow tiers
            run_len = _gg(rl)[:n_runs].astype(np.int64)
            run_char = _gg(rc)[:n_runs].astype(np.uint8)
        mark("shm_download")
    return run_len, run_char


CLS_KEYS = ("pos", "length", "isa_next", "smaller_i", "until_next",
            "size", "key_k", "member_head", "member_off", "cls_of_slot")
PAIR_KEYS = ("bucket_pos", "cls_lo", "cls_hi", "bucket_of_class",
             "pair_lo", "pair_cnt")


def _unstack_cls(stack, n_classes):
    cls = {k: stack[i] for i, k in enumerate(CLS_KEYS)}
    cls["smaller"] = cls.pop("smaller_i") != 0
    cls["n_classes"] = n_classes
    return cls


def _unstack_pairs(stack, n_buckets, total):
    p = {k: stack[i] for i, k in enumerate(PAIR_KEYS)}
    p["n_buckets"] = n_buckets
    p["total"] = total
    return p


@functools.partial(jax.jit,
                   static_argnames=("mesh", "lh", "ln_", "R", "rounds",
                                    "cap_factor"))
def _stage_a_program(mesh, t, pos, ln, smaller, char, ref_sa, ref_isa,
                     ref_bwt, scal, lh: int, ln_: int, R: int,
                     rounds: int, cap_factor=None):
    D.set_cap_factor(cap_factor)

    def body(t, pos, ln, smaller, char, ref_sa, ref_isa, ref_bwt, scal):
        h, n, sn, d = scal[0], scal[1], scal[2], scal[3]
        ovf_scope = D.overflow_scope()
        flags = ovf_scope.__enter__()
        to_next, isa_next, succ = _fixup(t, pos, ln, h, ref_isa, lh, ln_,
                                         R)
        tails_cnt = _tail_counts(pos, to_next, h, lh, ln_, R)
        cls = _group(t, pos, ln, smaller, to_next, isa_next, h, n, lh, R)
        rank_to_head, sa_ord, cls_of_slot = _class_ranks(
            cls, ref_isa, h, d, n, lh, ln_, R)
        cls["cls_of_slot"] = cls_of_slot
        head_to_rank = _head_string_sa(rank_to_head, h, lh, R, rounds)
        final_rank, bwt_heads, succ_rank, member_rank_sorted = _rank_heads(
            cls, head_to_rank, char, succ, h, lh, R)
        slot_base = cls["member_off"]
        pairs = _tail_pairs_count(cls, h, lh, R)
        cls_stack = jnp.stack([
            cls["pos"], cls["length"], cls["isa_next"],
            cls["smaller"].astype(I64), cls["until_next"], cls["size"],
            cls["key_k"], cls["member_head"], cls["member_off"],
            cls["cls_of_slot"]])
        pairs_stack = jnp.stack([
            pairs["bucket_pos"], pairs["cls_lo"], pairs["cls_hi"],
            pairs["bucket_of_class"], pairs["pair_lo"],
            pairs["pair_cnt"]])
        # replicated scalars ride a per-shard P(AXIS) output (the host
        # reads a prefix) — a P() out spec would reject collective-
        # derived (device-varying) values under shard_map's vma checks
        ovf = D.overflow_any(flags)
        ovf_scope.__exit__(None, None, None)
        meta = jnp.stack([cls["n_classes"], pairs["n_buckets"],
                          pairs["total"], ovf])
        return (cls_stack, pairs_stack, meta, member_rank_sorted,
                cls_of_slot, sa_ord, bwt_heads, tails_cnt, slot_base)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS),) * 8 + (P(),),
        out_specs=(P(None, AXIS), P(None, AXIS), P(AXIS), P(AXIS),
                   P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)))(
        t, pos, ln, smaller, char, ref_sa, ref_isa, ref_bwt, scal)


@functools.partial(jax.jit, static_argnames=("mesh", "lh", "lp", "R",
                                             "cap_factor"))
def _stage_good_program(mesh, cls_stack, pairs_stack, slot_base, meta,
                        scal, lh: int, lp: int, R: int, cap_factor=None):
    D.set_cap_factor(cap_factor)

    def body(cls_stack, pairs_stack, slot_base, meta, scal):
        h, n = scal[0], scal[1]
        cls = _unstack_cls(cls_stack, meta[0])
        pairs = _unstack_pairs(pairs_stack, meta[1], meta[2])
        with D.overflow_scope() as flags:
            (counter, n_exact, exact_members, e_pidx, e_fnd,
             src_cls) = _tail_good(cls, pairs, slot_base, h, n, lh, lp, R)
            ovf = D.overflow_any(flags)
        return (counter, jnp.stack([n_exact, exact_members, ovf]), e_pidx,
                e_fnd, src_cls)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)))(
        cls_stack, pairs_stack, slot_base, meta, scal)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "lh", "lp", "lm", "R",
                                    "cap_factor"))
def _stage_exact(mesh, cls_stack, pairs_stack, slot_base,
                 member_rank_sorted, cls_of_slot, e_pidx, e_fnd, src_cls,
                 escal, lh: int, lp: int, lm: int, R: int,
                 cap_factor=None):
    D.set_cap_factor(cap_factor)

    def body(cls_stack, pairs_stack, slot_base, member_rank_sorted,
             cls_of_slot, e_pidx, e_fnd, src_cls, escal):
        cls = _unstack_cls(cls_stack, escal[0] * 0 + (1 << 60))
        pairs = _unstack_pairs(pairs_stack, 0, 0)
        with D.overflow_scope() as flags:
            counter = _tail_exact(cls, pairs, slot_base,
                                  member_rank_sorted, cls_of_slot, e_pidx,
                                  e_fnd, src_cls, escal[0], escal[1],
                                  lh, lp, lm, R)
            ovf = D.overflow_any(flags)
        return counter, ovf[None]

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)))(
        cls_stack, pairs_stack, slot_base, member_rank_sorted,
        cls_of_slot, e_pidx, e_fnd, src_cls, escal)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "lh", "ln_", "R", "rle_quirk",
                                    "cap_factor"))
def _stage_runs(mesh, cls_stack, sa_ord, slot_base, counter, tails_cnt,
                bwt_heads, ref_sa, ref_isa, ref_bwt, scal,
                lh: int, ln_: int, R: int, rle_quirk: bool,
                cap_factor=None):
    D.set_cap_factor(cap_factor)

    from ..engine.device_merge import _big_tier_sizes, _p8_tier_sizes
    le = 4 * lh + ln_
    p8_ts = _p8_tier_sizes(le)
    big_ts = _big_tier_sizes(min(le, max(1024, le >> 6)))

    def body(cls_stack, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
             ref_sa, ref_isa, ref_bwt, scal):
        h, n, sn, d = scal[0], scal[1], scal[2], scal[3]
        # n_classes rides in cls_stack's unused meta? recompute: classes
        # are BIG-padded in pos — count them
        n_classes = _tot((cls_stack[0] < BIG).astype(I64))
        cls = _unstack_cls(cls_stack, n_classes)
        with D.overflow_scope() as flags:
            (rl, rc, n_runs, packed8, bkey, bpay,
             n_big) = _runs_emit(cls, sa_ord, slot_base, counter,
                                 tails_cnt, bwt_heads, ref_sa,
                                 ref_isa, ref_bwt, d, n, h, lh,
                                 ln_, R, rle_quirk)
            ovf = D.overflow_any(flags)
        # per-shard geometric prefixes: tier t of the packed list holds
        # each shard's first t local rows (host reassembles by shard)
        p8_tiers = tuple(jax.lax.dynamic_slice(packed8, (0,), (t,))
                         for t in p8_ts)
        big_tiers = tuple(
            (jax.lax.dynamic_slice(bkey, (0,), (t,)),
             jax.lax.dynamic_slice(bpay, (0,), (t,)))
            for t in big_ts)
        return (rl, rc, jnp.stack([n_runs, ovf, n_big]),
                p8_tiers, big_tiers)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, AXIS),) + (P(AXIS),) * 8 + (P(),),
        out_specs=(P(AXIS), P(AXIS), P(AXIS),
                   tuple(P(AXIS) for _ in p8_ts),
                   tuple((P(AXIS), P(AXIS)) for _ in big_ts)))(
        cls_stack, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
        ref_sa, ref_isa, ref_bwt, scal)
