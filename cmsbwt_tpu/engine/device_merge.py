"""Device-side downstream merge: head fixup -> grouping -> ranking -> tail
positioning -> run assembly, entirely on the accelerator.

Replaces the host numpy/OpenMP engine (heads.py / ranking.py / tails.py /
merge.py) for the dense backend: head records stay on device after the MS
scan, the reference index is never downloaded, and only the final run list
(O(n + H)) crosses the host link. Reference semantics
mirrored per stage:

* fixup           ref CMS-BWT-functions.cpp:566-586   (covering phrase)
* grouping        ref :594-603 + match.h:23-33        (class map + comparator)
* ranking         ref :627-695                        (SA walk + libsais_int)
* tail position   ref :1517-1603                      (incl. counterBad merge)
* run assembly    ref :939-1085 / :1630-1777          (plain + RLE quirk)

Formulation: every per-element binary search becomes a SORTED JOIN —
targets and queries are concatenated, sorted by (key, tie-flag), and the
match is recovered with a reverse running min — so the hot paths are
O((P+C) log) sort passes instead of dependent gathers. Scatters are used
only where the write set is disjoint by construction. Whether a direct
gather or ``searchsorted`` is cheaper per stage on the GPU awaits
measurement.

All stages use int32 indices (n, sn < 2^31 — the reference's own caps,
CMS-BWT-functions.cpp:246, CMS-BWT.h:44-46).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INT_MAX = np.int32(2**31 - 1)
I64_BIG = np.int64(1) << 62
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def sn_bound() -> int:
    """Collection-size cap of the int32-keyed device merge (and of the
    unblocked device scans). The reference's ``sn`` is uint64
    (ref CMS-BWT.h:26,46) — unbounded — so collections at/above this bound
    must route through the int64-safe path (blocked dense scan + host
    merge; see pipeline.compute_bwt). Overridable via ``CMSBWT_SN_BOUND``
    so CI can prove the over-bound route byte-equal at toy scale."""
    import os
    return int(os.environ.get("CMSBWT_SN_BOUND", 1 << 31))


def _check_sn(sn: int) -> None:
    if sn >= sn_bound():
        raise ValueError(
            f"collection has {sn} chars >= the device merge's int32 bound "
            f"({sn_bound()}): use merge_backend='host' with a blocked scan "
            "(pipeline routes backend=auto there automatically)")


def _rev_fill_min(vals):
    """Nearest at-or-after fill: running min from the right.

    flip + forward + flip, NOT ``reverse=True``: reverse-direction
    cumulative ops have compiled much slower than forward ones, while
    ``lax.rev`` is free. Whether the GPU compiler still needs this awaits
    measurement."""
    return jax.lax.cummin(vals[::-1])[::-1]


# ---------------------------------------------------------------------------
# Stage 1: head fixup (ref :566-586) + per-position tail counts (ref :368-377)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def fixup_dev(t, pos, ln, h, ref_isa, h_pad: int):
    """to_next / isa_next / succ per head. ``ends`` is globally
    non-decreasing (the MS sliding property), so the covering-phrase search
    (ref :566-571) is an upper_bound = end-of-equal-run, gather-free."""
    idx = jnp.arange(h_pad, dtype=jnp.int32)
    valid = idx < h
    ends = jnp.where(valid, t + ln, INT_MAX)
    pseudo = valid & (ln == 0)
    barrier = _rev_fill_min(jnp.where(pseudo, idx, jnp.int32(h_pad)))
    is_run_end = jnp.concatenate(
        [ends[1:] != ends[:-1], jnp.ones(1, dtype=bool)])
    run_end = _rev_fill_min(jnp.where(is_run_end, idx, jnp.int32(h_pad)))
    j = jnp.minimum(run_end + 1, barrier)
    j = jnp.where(pseudo, idx, j)
    t_nxt = jnp.concatenate([t[1:], t[-1:]])
    to_next = jnp.where(valid & (ln > 0), t_nxt - t - 1, 0)
    jc = jnp.clip(j, 0, h_pad - 1)
    img = pos[jc] + (ends - t[jc])
    isa_next = jnp.where(
        valid, ref_isa[jnp.clip(img, 0, ref_isa.shape[0] - 1)], 0)
    return to_next, isa_next, j


@functools.partial(jax.jit, static_argnames=("h_pad", "n_pad"))
def tail_counts_dev(pos, to_next, h, h_pad: int, n_pad: int):
    """tails per reference text position, from head spans (difference
    array; the write sets of the two scatters are per-head disjoint)."""
    idx = jnp.arange(h_pad, dtype=jnp.int32)
    valid = (idx < h) & (to_next > 0)
    hp = pos + 1
    dump = jnp.int32(n_pad + 1)
    diff = jnp.zeros(n_pad + 2, jnp.int32)
    diff = diff.at[jnp.where(valid, hp, dump)].add(1, mode="drop")
    diff = diff.at[jnp.where(valid, hp + to_next, dump)].add(-1, mode="drop")
    return jnp.cumsum(diff[:n_pad])


# ---------------------------------------------------------------------------
# Stage 2: class grouping (ref :594-603, match.h:27-33)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def group_dev(pos, ln, smaller, to_next, isa_next, h, n, h_pad: int):
    """Group heads into (pos, len, isaNext) classes; classes come out in
    TEXT order (pos, K, isaNext) with members grouped per class in
    insertion (idx) order, exactly like engine/heads.py."""
    idx = jnp.arange(h_pad, dtype=jnp.int32)
    valid = idx < h
    LOW30 = (jnp.int64(1) << 30) - 1
    LOW31 = (jnp.int64(1) << 31) - 1
    with jax.enable_x64(True):
        # (len, isa) packed by SHIFTS, not the old scale-multiply: the
        # shift pack is order-equivalent (isa <= n < 2^30) and unpacks
        # with mask/shift, so len/isa no longer ride as extra sort
        # operands (compile time scales ~linearly with sort operand count
        # on this backend: the old 9-operand text-order sort pushed this
        # one program to ~3.5 min of XLA compile)
        pk_li = (ln.astype(jnp.int64) << 30) | isa_next.astype(jnp.int64)
        key1 = jnp.where(valid, pos, INT_MAX)
        pk_li = jnp.where(valid, pk_li, I64_BIG)
        p_s, li_s, order = jax.lax.sort((key1, pk_li, idx), num_keys=2)
        new_grp = jnp.concatenate(
            [jnp.ones(1, dtype=bool),
             (p_s[1:] != p_s[:-1]) | (li_s[1:] != li_s[:-1])])
        valid_s = jnp.arange(h_pad) < h  # sorted: valid entries first
        firsts = new_grp & valid_s
        # jnp.sum promotes integer inputs to the default int (int64 under
        # x64) — pin int32 so consumers outside the x64 block don't warn
        n_classes = jnp.sum(firsts.astype(jnp.int32)).astype(jnp.int32)
        gid = jnp.cumsum(firsts.astype(jnp.int32)) - 1  # class id, sorted ord
        # compact class firsts; payloads packed two-per-int64 (pos|head,
        # len|isa). ``fi`` (each first's sorted position) equals the
        # sorted key itself on the valid prefix — no payload slot needed
        ckey = jnp.where(firsts, idx, INT_MAX)
        pay1 = (p_s.astype(jnp.int64) << 31) | order.astype(jnp.int64)
        fi, pay1_s, pay2_s = jax.lax.sort((ckey, pay1, li_s), num_keys=1)
        cls_pos = (pay1_s >> 31).astype(jnp.int32)
        first_head = (pay1_s & LOW31).astype(jnp.int32)
        cls_len = (pay2_s >> 30).astype(jnp.int32)
        cls_isa = (pay2_s & LOW30).astype(jnp.int32)
    cvalid = jnp.arange(h_pad, dtype=jnp.int32) < n_classes
    fh = jnp.clip(first_head, 0, h_pad - 1)
    cls_smaller = jnp.where(cvalid, smaller[fh], False)
    cls_until = jnp.where(cvalid, to_next[fh], 0)
    fi_nxt = jnp.concatenate([fi[1:], fi[-1:]])
    cls_size = jnp.where(
        cvalid,
        jnp.where(jnp.arange(h_pad, dtype=jnp.int32) + 1 < n_classes,
                  fi_nxt, h) - fi, 0)
    key_k = jnp.where(cls_smaller, cls_len, 2 * n - cls_len)
    key_k = jnp.where(cvalid, key_k, INT_MAX)

    # text order: (pos, K, isaNext); K/isa ride in the shift-packed key2,
    # (order, until) and (size, smaller) in two packed payloads
    with jax.enable_x64(True):
        pk_ki = jnp.where(cvalid,
                          (key_k.astype(jnp.int64) << 30)
                          | cls_isa.astype(jnp.int64), I64_BIG)
        cpos_key = jnp.where(cvalid, cls_pos, INT_MAX)
        cidx = jnp.arange(h_pad, dtype=jnp.int32)
        tpay1 = (cidx.astype(jnp.int64) << 31) | cls_until.astype(jnp.int64)
        tpay2 = (cls_size.astype(jnp.int64) << 1) \
            | cls_smaller.astype(jnp.int64)
        tpos, tki, tpay1_s, tpay2_s = jax.lax.sort(
            (cpos_key, pk_ki, tpay1, tpay2), num_keys=2)
        torder = (tpay1_s >> 31).astype(jnp.int32)
        tuntil = (tpay1_s & LOW31).astype(jnp.int32)
        tsize = (tpay2_s >> 1).astype(jnp.int32)
        tsml = (tpay2_s & 1).astype(jnp.int32)
        tkk_raw = (tki >> 30).astype(jnp.int32)
        tisa = (tki & LOW30).astype(jnp.int32)
    cvalid2 = jnp.arange(h_pad, dtype=jnp.int32) < n_classes
    tkk = jnp.where(cvalid2, tkk_raw, INT_MAX)
    tlen = jnp.where(tsml != 0, tkk_raw, 2 * n - tkk_raw)
    # rank of each (grouped-order) class in text order
    _, text_rank = jax.lax.sort((torder, cidx), num_keys=1)
    # members regrouped by text-ordered class (stable keeps idx order)
    mkey = jnp.where(valid_s, text_rank[jnp.clip(gid, 0, h_pad - 1)],
                     INT_MAX)
    _, member_head = jax.lax.sort((mkey, order), num_keys=1)
    member_off = jnp.cumsum(tsize) - tsize  # exclusive prefix

    return dict(n_classes=n_classes, pos=tpos, length=tlen, isa_next=tisa,
                smaller=tsml != 0, until_next=tuntil, size=tsize,
                key_k=tkk, member_head=member_head, member_off=member_off,
                gid_sorted=gid, order_sorted=order, text_rank=text_rank)


# ---------------------------------------------------------------------------
# Stage 3: ranking (ref :627-695)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def class_ranks_dev(cls, ref_isa, h, d, n, h_pad: int):
    """rankToHead (text order over head idx, terminator 0 appended) + the
    SA-walk class order. Pseudo class (pos=n-1, ISA 0) members get ranks
    1..D-1 in idx order; class at sa-walk position c>=1 gets rank D+c-1...
    matching assign_class_ranks: rank_value[sa_ord] = arange + d, pseudo
    members 1..D-1."""
    cidx = jnp.arange(h_pad, dtype=jnp.int32)
    cvalid = cidx < cls["n_classes"]
    isa_pos = jnp.where(cvalid,
                        ref_isa[jnp.clip(cls["pos"], 0,
                                         ref_isa.shape[0] - 1)], INT_MAX)
    with jax.enable_x64(True):
        pk = jnp.where(cvalid,
                       cls["key_k"].astype(jnp.int64)
                       * (n + 1).astype(jnp.int64)
                       + cls["isa_next"].astype(jnp.int64), I64_BIG)
        _, _, sa_ord = jax.lax.sort((isa_pos, pk, cidx), num_keys=2)
    # rank_value per text-order class id
    rank_value = jnp.zeros(h_pad, jnp.int32).at[
        jnp.clip(sa_ord, 0, h_pad - 1)].set(
        jnp.where(cvalid, cidx + d, 0), mode="drop")
    pseudo_cls = sa_ord[0]
    # per-member rank: members are grouped by text-order class
    midx = jnp.arange(h_pad, dtype=jnp.int32)
    mvalid = midx < h
    # class of each member slot: fill from member_off boundaries
    starts = jnp.zeros(h_pad, jnp.int32).at[
        jnp.clip(cls["member_off"], 0, h_pad - 1)].max(
        jnp.where(cvalid & (cls["size"] > 0), cidx + 1, 0), mode="drop")
    cls_of_slot = jax.lax.cummax(starts) - 1
    within = midx - cls["member_off"][jnp.clip(cls_of_slot, 0, h_pad - 1)]
    is_pseudo = cls_of_slot == pseudo_cls
    mrank = jnp.where(is_pseudo, 1 + within,
                      rank_value[jnp.clip(cls_of_slot, 0, h_pad - 1)])
    mrank = jnp.where(mvalid, mrank, 0)
    # scatter to head-idx order: rank_to_head[member_head] = mrank
    rank_to_head = jnp.zeros(h_pad + 1, jnp.int32).at[
        jnp.where(mvalid, cls["member_head"], h_pad)].set(
        mrank, mode="drop")
    rank_to_head = rank_to_head.at[h].set(0)
    return rank_to_head, sa_ord, cls_of_slot


@functools.partial(jax.jit, static_argnames=("h_pad",))
def head_string_sa_dev(rank_to_head, h, h_pad: int):
    """Suffix sort of the head rank string (replaces libsais_int, ref :648).

    The [0, h] prefix is the real string (terminator 0 at h); positions
    beyond get distinct ascending values above every rank so their suffixes
    resolve immediately and cluster at the top of the SA."""
    from ..index.device import suffix_array_device
    L = h_pad + 1
    idx = jnp.arange(L, dtype=jnp.int32)
    BIG = jnp.int32(1) << 30
    s = jnp.where(idx <= h, rank_to_head, BIG + idx)
    sa, _, _, _ = suffix_array_device(s, L)
    # compact the real suffixes (sa <= h), preserving order
    key = jnp.where(sa <= h, idx, INT_MAX)
    _, head_to_rank = jax.lax.sort((key, sa), num_keys=1)
    return head_to_rank  # first h+1 entries are the real SA


@functools.partial(jax.jit, static_argnames=("h_pad",))
def rank_heads_dev(cls, head_to_rank, char, succ, h, h_pad: int):
    """final ranks, head BWT, successor re-rank, slot layout
    (ref :661-687 + prefixSumForPositions :697-707)."""
    idx = jnp.arange(h_pad, dtype=jnp.int32)
    valid = idx < h
    sa_body = head_to_rank[1:]  # length h_pad; first h valid
    # final_rank[sa_body[r]] = r
    final_rank = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(valid, sa_body, h_pad)].set(idx, mode="drop")
    bwt_heads = char[jnp.clip(sa_body, 0, h_pad - 1)]
    succ_rank = final_rank[jnp.clip(succ, 0, h_pad - 1)]
    # member ranks aligned with the text-order slot layout, sorted per class
    member_rank = succ_rank[jnp.clip(cls["member_head"], 0, h_pad - 1)]
    cls_of_slot = cls["cls_of_slot"]
    with jax.enable_x64(True):
        pk = jnp.where(valid,
                       cls_of_slot.astype(jnp.int64) * (h_pad + 2)
                       + member_rank.astype(jnp.int64), I64_BIG)
        _, member_rank_sorted = jax.lax.sort((pk, member_rank), num_keys=1)
    return final_rank, bwt_heads, succ_rank, member_rank_sorted


# ---------------------------------------------------------------------------
# Stage 4: tail positioning (ref :1517-1603) as sorted joins
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def tail_pairs_count_dev(cls, h_pad: int):
    """Buckets (distinct head positions) + per-class interesting-bucket
    ranges; returns the pair total for host-side padding."""
    cidx = jnp.arange(h_pad, dtype=jnp.int32)
    cvalid = cidx < cls["n_classes"]
    pos = cls["pos"]
    new_b = jnp.concatenate([jnp.ones(1, dtype=bool),
                             pos[1:] != pos[:-1]]) & cvalid
    n_buckets = jnp.sum(new_b.astype(jnp.int32))
    bid = jnp.cumsum(new_b.astype(jnp.int32)) - 1  # bucket of class (text ord)
    # compact bucket positions + class ranges
    bkey = jnp.where(new_b, cidx, INT_MAX)
    _, bucket_pos, cls_lo = jax.lax.sort((bkey, pos, cidx), num_keys=1)
    bvalid = cidx < n_buckets
    cls_hi = jnp.where(
        bvalid,
        jnp.where(cidx + 1 < n_buckets,
                  jnp.concatenate([cls_lo[1:], cls_lo[-1:]]),
                  cls["n_classes"]), 0)
    # per class: range of buckets intersecting [pos+1, pos+until] via a
    # sorted join (bucket_pos is sorted; queries are class endpoints)
    lo = _join_lower_bound(jnp.where(bvalid, bucket_pos, INT_MAX), n_buckets,
                           jnp.where(cvalid, pos + 1, INT_MAX), h_pad)
    hi = _join_lower_bound(jnp.where(bvalid, bucket_pos, INT_MAX), n_buckets,
                           jnp.where(cvalid, pos + cls["until_next"] + 1,
                                     INT_MAX), h_pad)
    cnt = jnp.where(cvalid, jnp.maximum(hi - lo, 0), 0)
    with jax.enable_x64(True):
        total = jnp.sum(cnt.astype(jnp.int64))
    return dict(bucket_pos=bucket_pos, n_buckets=n_buckets, cls_lo=cls_lo,
                cls_hi=cls_hi, bucket_of_class=bid, pair_lo=lo,
                pair_cnt=cnt, total=total)


def _join_lower_bound(sorted_vals, n_valid, queries, q_pad):
    """index of first sorted_vals[j] >= queries[i] (values INT_MAX-padded).

    One concat sort + reverse fill; ties resolve to the first equal target
    because queries sort before equal targets (flag key)."""
    nv = sorted_vals.shape[0]
    vals = jnp.concatenate([sorted_vals, queries])
    flag = jnp.concatenate([jnp.ones(nv, jnp.int32),
                            jnp.zeros(q_pad, jnp.int32)])
    srcidx = jnp.concatenate([jnp.arange(nv, dtype=jnp.int32),
                              jnp.arange(q_pad, dtype=jnp.int32)])
    v_s, f_s, i_s = jax.lax.sort((vals, flag, srcidx), num_keys=2)
    tgt = _rev_fill_min(jnp.where(f_s == 1, i_s, jnp.int32(nv)))
    # route answers back to query slots
    qkey = jnp.where(f_s == 0, i_s, INT_MAX)
    _, ans = jax.lax.sort((qkey, jnp.minimum(tgt, n_valid)), num_keys=1)
    return ans[:q_pad]


@functools.partial(jax.jit, static_argnames=("h_pad", "p_pad"))
def tail_good_dev(cls, pairs, slot_base, h, n, h_pad: int, p_pad: int):
    """Expand (class, bucket) pairs, lower_bound each query key in its
    bucket via one global sorted join, and credit the good path. Returns
    (counter partial, exact-pair info) — the exact path runs separately.

    Per-pair class attributes arrive by packed scatter+cummax segment
    fills, not gathers: a p_pad-length fill runs at memory bandwidth while
    a p_pad random gather serializes (~tens of M elem/s) — at millions of
    pairs the fills are the difference between a bandwidth-bound and a
    gather-bound kernel."""
    assert p_pad + 1 <= (1 << 30), "pair pack exceeds the 63-bit budget"
    cidx = jnp.arange(h_pad, dtype=jnp.int32)
    cvalid = cidx < cls["n_classes"]
    cnt = pairs["pair_cnt"]
    off = jnp.cumsum(cnt) - cnt  # exclusive
    pidx = jnp.arange(p_pad, dtype=jnp.int32)
    total = pairs["total"].astype(jnp.int32)
    pvalid = pidx < total
    # ONE batched (5, p_pad) packed scatter+cummax segment fill: value
    # ((off+1) << 33) | payload scattered at each class's first pair,
    # cummax-filled along the pair axis; payload <= 33 bits, marker
    # (off+1) < 2^30 keeps the pack in 63 bits. Scatter cost is per-UPDATE
    # (~160 ms per 1.4M-update scatter on this chip, measured), so five
    # independent fills were 5x the price of one 5-row fill with shared
    # indices; gathers are no refuge (a p_pad monotone gather measured
    # ~95 ms and fuses badly).
    with jax.enable_x64(True):
        at = jnp.where(cvalid & (cnt > 0), off, p_pad)
        mk = (off.astype(jnp.int64) + 1) << 33
        M33 = (jnp.int64(1) << 33) - 1
        pay = jnp.stack([
            (pairs["pair_lo"] - off + p_pad).astype(jnp.int64),
            ((cls["length"].astype(jnp.int64)
              + cls["pos"].astype(jnp.int64)) << 1)
            | cls["smaller"].astype(jnp.int64),
            cls["isa_next"].astype(jnp.int64),
            cls["size"].astype(jnp.int64),
            cidx.astype(jnp.int64) + 1,
        ])
        base = jnp.full((5, p_pad), -1, jnp.int64).at[:, at].max(
            mk[None, :] | pay, mode="drop")
        filled = jax.lax.cummax(base, axis=1) & M33
        delta1 = filled[0]
        s1s = filled[1]
    # b_idx = pidx + (pair_lo - off); biased by p_pad to stay non-negative
    b_idx = (pidx + delta1 - p_pad).astype(jnp.int32)
    b = pairs["bucket_pos"][jnp.clip(b_idx, 0, h_pad - 1)]
    # q_len = (length + pos) - b; smaller rides the low bit
    q_len = ((s1s >> 1) - b.astype(jnp.int64)).astype(jnp.int32)
    q_small = (s1s & 1) != 0
    q_isa = filled[2].astype(jnp.int32)
    q_size = filled[3].astype(jnp.int32)
    src_cls = jnp.clip(filled[4].astype(jnp.int32) - 1, 0, h_pad - 1)
    q_k = jnp.where(q_small, q_len, 2 * n - q_len)
    # global join: targets = classes (pos, K*(n+1)+isa), queries = (b, qk..).
    # The tie flag (queries sort before equal targets — the rev_fill below
    # must see an equal-key target AT-or-after the query) rides key2's low
    # bit, and the two payloads are disjoint by side (slot_base is consumed
    # at target rows, q_size at query rows), so the join sort carries 4
    # operands / 2 keys instead of 6 / 3 — the sort is the stage's cost.
    with jax.enable_x64(True):
        scale = (n + 1).astype(jnp.int64)
        t_k2 = jnp.where(cvalid,
                         cls["key_k"].astype(jnp.int64) * scale
                         + cls["isa_next"].astype(jnp.int64), I64_BIG)
        q_k2 = jnp.where(pvalid,
                         q_k.astype(jnp.int64) * scale
                         + q_isa.astype(jnp.int64), I64_BIG)
        key1 = jnp.concatenate([jnp.where(cvalid, cls["pos"], INT_MAX),
                                jnp.where(pvalid, b, INT_MAX)])
        key2f = jnp.concatenate(
            [jnp.where(cvalid, (t_k2 << 1) | 1, I64_BIG),
             jnp.where(pvalid, q_k2 << 1, I64_BIG)])
        srcidx = jnp.concatenate([cidx, pidx])
        pay = jnp.concatenate([slot_base[:h_pad], q_size])
        k1s, k2fs, i_s, pay_s = jax.lax.sort(
            (key1, key2f, srcidx, pay), num_keys=2)
        f_s = (k2fs & 1).astype(jnp.int32)
        k2s = k2fs >> 1
        slot_s = size_s = pay_s
    # Propagate the nearest-at-or-after target's attributes to each query
    # row by packed (row << 31 | payload) reverse cummins — the row is the
    # high field so the nearest target wins and each fill carries one
    # 31-bit payload. Replaces four p_pad random gathers at the found
    # class (gathers serialize; fills run at memory bandwidth). The
    # exact-key test needs no key_k/isa fill at all: sorted by (k1, k2),
    # a query's target has equal k2 iff the nearest target row lies inside
    # the query's own (k1, k2) run.
    jn_pad = h_pad + p_pad
    rowsi = jnp.arange(jn_pad, dtype=jnp.int32)
    with jax.enable_x64(True):
        rows = rowsi.astype(jnp.int64)
        FILL_BIG = jnp.int64((1 << 62) - 1)
        LOW31 = (jnp.int64(1) << 31) - 1

        def rev_fill(payload31):
            packed = jnp.where(f_s == 1, (rows << 31)
                               | payload31.astype(jnp.int64), FILL_BIG)
            # flip+forward (see _rev_fill_min): reverse lowering is slow
            return jax.lax.cummin(packed[::-1])[::-1]

        fp = rev_fill(k1s)          # nearest target's bucket pos + row
        f_pos = (fp & LOW31).astype(jnp.int32)
        t_row = (fp >> 31).astype(jnp.int32)
        f_cls = (rev_fill(i_s) & LOW31).astype(jnp.int32)
        change_next = jnp.concatenate(
            [(k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1]),
             jnp.ones(1, dtype=bool)])
    run_end = _rev_fill_min(jnp.where(change_next, rowsi, jnp.int32(jn_pad)))
    is_q = f_s == 0
    # pad rows (class and query alike) carry k1 == INT_MAX and never pass
    in_range_s = is_q & (f_pos == k1s) & (k1s < INT_MAX)
    exact_s = in_range_s & (t_row <= run_end)
    good_s = in_range_s & ~exact_s
    # credit the good path straight from sorted order. All good queries
    # crediting a target sit contiguously before that target row (same
    # sort bucket, smaller k2), so the credit is a cumsum difference
    # scattered at UNIQUE target rows — a colliding 11M-lane scatter-add
    # would serialize at gather speed.
    with jax.enable_x64(True):
        gcum = jnp.cumsum(jnp.where(good_s, size_s, 0).astype(jnp.int64))
        gexc = gcum - jnp.where(good_s, size_s, 0)
        prev_t = jnp.concatenate(
            [jnp.full(1, -1, jnp.int64),
             jax.lax.cummax(jnp.where(f_s == 1, rows, jnp.int64(-1)))[:-1]])
        pt = jnp.clip(prev_t, 0, jn_pad - 1).astype(jnp.int32)
        base_cum = jnp.where(prev_t >= 0, gcum[pt], 0)
        credit = (gcum - base_cum).astype(jnp.int32)
    is_t = f_s == 1
    counter = jnp.zeros(h_pad + 2, jnp.int32).at[
        jnp.where(is_t, slot_s, h_pad + 1)].add(
        jnp.where(is_t, credit, 0), mode="drop")
    n_exact = jnp.sum(exact_s.astype(jnp.int32)).astype(jnp.int32)
    with jax.enable_x64(True):
        exact_members = jnp.sum(jnp.where(exact_s, size_s, 0)
                                .astype(jnp.int64))
    # compact exact pairs as (pair idx, found class); the exact path later
    # recovers src class / bucket idx with e_pad-sized (tiny) gathers
    ekey = jnp.where(exact_s, i_s, INT_MAX)
    _, e_pidx, e_fnd = jax.lax.sort((ekey, i_s, f_cls), num_keys=1)
    return (counter, n_exact, exact_members, e_pidx[:p_pad],
            e_fnd[:p_pad], src_cls)


@functools.partial(jax.jit, static_argnames=("h_pad", "e_pad", "em_pad"))
def tail_exact_dev(counter_in, cls, pairs, slot_base, member_rank_sorted,
                   cls_of_slot, e_pidx, e_fnd, src_cls, n_exact, h,
                   h_pad: int, e_pad: int, em_pad: int):
    """Exact-key (counterBad) path: member-wise sorted-list merge
    (ref :1567-1589) as one upper_bound join over the global slot array.

    ``e_pidx``/``e_fnd`` are the compacted exact pairs (pair index, found
    class); src class and bucket idx come from e_pad-sized gathers into
    the per-pair arrays — tiny relative to the member join. Returns
    ``counter_in`` plus this path's credits (the add lives in-program: a
    bare ``a + b`` on device arrays is its own jit program, and every
    extra program costs a serial cold compile)."""
    eidx = jnp.arange(e_pad, dtype=jnp.int32)
    evalid = eidx < n_exact
    ep = jnp.clip(e_pidx[:e_pad], 0, src_cls.shape[0] - 1)
    e_src = src_cls[ep]
    e_fnd = e_fnd[:e_pad]
    msz = jnp.where(evalid, cls["size"][e_src], 0)
    off = jnp.cumsum(msz) - msz
    midx = jnp.arange(em_pad, dtype=jnp.int32)
    with jax.enable_x64(True):
        tot = jnp.sum(msz.astype(jnp.int64)).astype(jnp.int32)
    mvalid = midx < tot
    starts = jnp.zeros(em_pad, jnp.int32).at[
        jnp.where(evalid & (msz > 0), off, em_pad)].max(
        eidx + 1, mode="drop")
    pair_of = jnp.clip(jax.lax.cummax(starts) - 1, 0, e_pad - 1)
    within = midx - off[pair_of]
    src = e_src[pair_of]
    dst = e_fnd[pair_of]
    q = member_rank_sorted[jnp.clip(slot_base[src] + within, 0, h_pad - 1)]
    # upper_bound join: targets = (class-of-slot, member_rank_sorted, slot),
    # queries = (dst, q); equal targets sort BEFORE the query (flag) so the
    # fill lands on the first rank STRICTLY greater (upper bound)
    hvalid = jnp.arange(h_pad, dtype=jnp.int32) < h
    with jax.enable_x64(True):
        W = (h_pad + 2)
        tkey = jnp.where(hvalid,
                         cls_of_slot.astype(jnp.int64) * W * 4
                         + member_rank_sorted.astype(jnp.int64) * 4 + 1,
                         I64_BIG)
        qkey = jnp.where(mvalid,
                         dst.astype(jnp.int64) * W * 4
                         + q.astype(jnp.int64) * 4 + 2, I64_BIG)
        keys = jnp.concatenate([tkey, qkey])
        srcidx = jnp.concatenate([jnp.arange(h_pad, dtype=jnp.int32),
                                  midx])
        flag = jnp.concatenate([jnp.ones(h_pad, jnp.int32),
                                jnp.zeros(em_pad, jnp.int32)])
        k_s, f_s, i_s = jax.lax.sort((keys, flag, srcidx), num_keys=2)
    tgt = _rev_fill_min(jnp.where(f_s == 1, i_s, jnp.int32(h_pad)))
    qk2 = jnp.where(f_s == 0, i_s, INT_MAX)
    _, p_slot = jax.lax.sort((qk2, jnp.clip(tgt, 0, h_pad - 1)), num_keys=1)
    p_slot = p_slot[:em_pad]
    inb = mvalid & (cls_of_slot[p_slot] == dst) & \
        (tgt[0] * 0 + 1 > 0)  # keep shape
    # a found slot outside the dst class means the walk ran off the list
    counter = jnp.zeros(h_pad + 2, jnp.int32).at[
        jnp.where(inb, p_slot, h_pad + 1)].add(1, mode="drop")
    # spill: next class's base slot, only if it exists in the same bucket
    has_next = (dst + 1) < pairs["cls_hi"][
        jnp.clip(pairs["bucket_of_class"][dst], 0, h_pad - 1)]
    spill_ok = mvalid & ~inb & has_next
    counter = counter.at[
        jnp.where(spill_ok, slot_base[jnp.clip(dst + 1, 0, h_pad - 1)],
                  h_pad + 1)].add(1, mode="drop")
    return counter_in + counter


# ---------------------------------------------------------------------------
# Stage 5: run assembly (ref :939-1085 / :1630-1777)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("h_pad", "n_pad", "rle_quirk"))
def runs_emit_dev(cls, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
                  ref_sa, ref_isa, ref_bwt, d, n,
                  h_pad: int, n_pad: int, rle_quirk: bool):
    """Assemble the output run list (the traversal of engine/merge.py:
    build_runs / ref :939-1085) by SORTED EMISSION instead of dense
    scatters: every run source yields (offset, len, char) lanes, one sort
    by offset orders them, adjacent equal-char runs merge on device (both
    writers merge adjacent equal chars anyway — ref :1003-1085 — so
    pre-merging is byte-transparent for either format), and a second sort
    compacts the merged list for a packed O(runs) download.

    Returns (packed uint32 ``len<<8|char``, len int32, char uint8,
    scalars [n_runs, maxlen]); the caller picks packed vs unpacked by
    ``maxlen < 2**24``.
    """
    cidx = jnp.arange(h_pad, dtype=jnp.int32)
    nec = cls["n_classes"] - 1
    evalid = cidx < nec
    ecls = jnp.clip(sa_ord[1:], 0, h_pad - 1)  # drop pseudo  [h_pad-1]
    ecls = jnp.concatenate([ecls, jnp.zeros(1, jnp.int32)])
    m_c = jnp.where(evalid, cls["size"][ecls], 0)
    bucket_rank = jnp.where(
        evalid, ref_isa[jnp.clip(cls["pos"][ecls], 0, n_pad - 1)], INT_MAX)
    new_b = jnp.concatenate([jnp.ones(1, dtype=bool),
                             bucket_rank[1:] != bucket_rank[:-1]]) & evalid
    bid = jnp.cumsum(new_b.astype(jnp.int32)) - 1
    # per-rank run counts: 1 per simple rank; mixed = 2*hb + (ncls | 1)
    hb_at = jnp.zeros(n_pad, jnp.int32).at[
        jnp.where(evalid, bucket_rank, 0)].add(m_c, mode="drop")
    ncls_at = jnp.zeros(n_pad, jnp.int32).at[
        jnp.where(evalid, bucket_rank, 0)].add(1, mode="drop")
    extra = 2 * hb_at + (ncls_at if rle_quirk
                         else jnp.minimum(ncls_at, 1)) - \
        jnp.minimum(ncls_at, 1)
    ridx = jnp.arange(n_pad, dtype=jnp.int32)
    # run-slot offsets and emitted-char prefix sums are both bounded by the
    # int32 regime (total runs <= sn + n + 2h, output chars == sn < 2^31),
    # so the lane sort runs on int32 keys
    rank_valid = (ridx >= 1) & (ridx < n)
    runs_per_rank = jnp.where(rank_valid, 1 + extra, 0)
    offsets = (jnp.cumsum(runs_per_rank) - runs_per_rank) + (d - 1)

    # --- lane sources (offset, len, char) ---
    # A: prelude BWTheads[0..D-2] (ref :946)
    a_off = cidx
    a_len = jnp.where(cidx < d - 1, 1, 0)
    a_chr = bwt_heads[jnp.clip(cidx, 0, h_pad - 1)].astype(jnp.int32)
    # B: simple buckets — one tails run each
    simple = rank_valid & (extra == 0)
    sa_r = jnp.clip(ref_sa, 0, n_pad - 1)
    b_off = offsets
    b_len = jnp.where(simple, tails_cnt[sa_r], 0)
    b_chr = ref_bwt.astype(jnp.int32)
    # class-level geometry (identical to runs layout in engine/merge.py)
    bchar = ref_bwt[jnp.clip(bucket_rank, 0, n_pad - 1)] \
        .astype(jnp.int32)
    first_of_b = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(new_b, jnp.clip(bid, 0, h_pad - 1), h_pad - 1)].set(
        cidx, mode="drop")
    k_c = cidx - first_of_b[jnp.clip(bid, 0, h_pad - 1)]
    ex_mc = jnp.cumsum(m_c) - m_c
    mc_first = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(new_b, jnp.clip(bid, 0, h_pad - 1), h_pad - 1)].set(
        ex_mc, mode="drop")
    mc_before = ex_mc - mc_first[jnp.clip(bid, 0, h_pad - 1)]
    cls_start = offsets[jnp.clip(bucket_rank, 0, n_pad - 1)] + \
        2 * mc_before + (k_c if rle_quirk else 0)
    # C/D: per member slot — tails run + the head's own char
    midx = jnp.arange(h_pad, dtype=jnp.int32)
    tot_slots = jnp.sum(m_c)
    mvalid = midx < tot_slots
    base_c = slot_base[ecls]
    cstart = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(evalid & (m_c > 0), ex_mc, h_pad)].max(
        cidx + 1, mode="drop")
    cls_of = jnp.clip(jax.lax.cummax(cstart) - 1, 0, h_pad - 1)
    within = midx - ex_mc[cls_of]
    slot_text = jnp.clip(base_c[cls_of] + within, 0, h_pad - 1)
    rt = cls_start[cls_of] + 2 * within
    cnt_slot = counter[slot_text]
    c_off = rt
    c_len = jnp.where(mvalid, cnt_slot, 0)
    c_chr = bchar[cls_of]
    d_off = rt + 1
    d_len = jnp.where(mvalid, 1, 0)
    d_chr = bwt_heads[jnp.clip(d - 1 + midx, 0, h_pad - 1)] \
        .astype(jnp.int32)
    # E: residuals — per class (quirk) / per last class of bucket
    ccnt = jnp.cumsum(jnp.where(mvalid, cnt_slot, 0))
    csum_hi = ccnt[jnp.clip(ex_mc + m_c - 1, 0, h_pad - 1)]
    csum_lo = jnp.where(ex_mc > 0,
                        ccnt[jnp.clip(ex_mc - 1, 0, h_pad - 1)], 0)
    csum_c = jnp.where(evalid & (m_c > 0), csum_hi - csum_lo, 0)
    inc = csum_c + m_c
    cum_inc = jnp.cumsum(inc)
    cum_exc_first = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(new_b, jnp.clip(bid, 0, h_pad - 1), h_pad - 1)].set(
        cum_inc - inc, mode="drop")
    cum_inc_b = cum_inc - cum_exc_first[jnp.clip(bid, 0, h_pad - 1)]
    hb_b = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(evalid, jnp.clip(bid, 0, h_pad - 1), h_pad - 1)].add(
        m_c, mode="drop")
    b_total = hb_b[jnp.clip(bid, 0, h_pad - 1)] + tails_cnt[
        jnp.clip(ref_sa[jnp.clip(bucket_rank, 0, n_pad - 1)], 0,
                 n_pad - 1)]
    if rle_quirk:
        e_valid = evalid
        e_off = cls_start + 2 * m_c
    else:
        # new_b is masked False beyond the valid classes, so the
        # shifted flag misses the final class — or it in explicitly
        is_last_of_b = jnp.concatenate(
            [new_b[1:], jnp.ones(1, dtype=bool)]) | (cidx + 1 == nec)
        e_valid = evalid & is_last_of_b
        hb_c = hb_b[jnp.clip(bid, 0, h_pad - 1)]
        e_off = offsets[jnp.clip(bucket_rank, 0, n_pad - 1)] + 2 * hb_c
    e_len = jnp.where(e_valid, b_total - cum_inc_b, 0)
    e_chr = bchar

    off = jnp.concatenate([a_off, b_off, c_off, d_off, e_off])
    lens = jnp.concatenate([a_len, b_len, c_len, d_len, e_len])
    chars = jnp.concatenate([a_chr, b_chr, c_chr, d_chr, e_chr])
    # run offsets are distinct by construction; zero-length and invalid
    # lanes sort to the tail and drop out
    key = jnp.where(lens > 0, off, INT_MAX)
    k_s, len_s, chr_s = jax.lax.sort((key, lens, chars), num_keys=1)
    L = off.shape[0]
    rowi = jnp.arange(L, dtype=jnp.int32)
    valid_s = (k_s < INT_MAX) & (len_s > 0)
    with jax.enable_x64(True):
        prv_chr = jnp.concatenate([jnp.full(1, -1, jnp.int32), chr_s[:-1]])
        prv_valid = jnp.concatenate([jnp.zeros(1, bool), valid_s[:-1]])
        nxt_chr = jnp.concatenate([chr_s[1:], jnp.full(1, -1, jnp.int32)])
        nxt_valid = jnp.concatenate([valid_s[1:], jnp.zeros(1, bool)])
        new_g = valid_s & (~prv_valid | (prv_chr != chr_s))
        is_last = valid_s & (~nxt_valid | (nxt_chr != chr_s))
        # merged length at each group's last lane: cumsum difference, the
        # group-start exclusive sum forward-filled by a packed cummax
        cum = jnp.cumsum(len_s.astype(jnp.int64))
        exc = cum - len_s
        packedg = jnp.where(
            new_g, (rowi.astype(jnp.int64) << 32) | exc, jnp.int64(-1))
        fe = jax.lax.cummax(packedg) & ((jnp.int64(1) << 32) - 1)
        lenm = jnp.where(is_last, cum - fe, 0).astype(jnp.int32)
        n_groups = jnp.sum(is_last.astype(jnp.int32)).astype(jnp.int32)
        maxlen = jnp.max(lenm)
        key2 = jnp.where(is_last, rowi, INT_MAX)
        _, rl, rc = jax.lax.sort((key2, lenm, chr_s), num_keys=1)
    # two-tier download: ONE byte per run — 6-bit length + 2-bit ACGT
    # code — with runs that don't fit (len >= 64 or a non-ACGT char:
    # separators, the ref-BWT's 0 char, rare alphabet bytes) spilled to a
    # compacted (index, len, char) overflow list, so the run list crosses
    # the host link in about a byte per run.
    ridx2 = jnp.arange(rl.shape[0], dtype=jnp.int32)
    rvalid = ridx2 < n_groups
    code = (jnp.where(rc == 67, 1, 0) + jnp.where(rc == 71, 2, 0)
            + jnp.where(rc == 84, 3, 0)).astype(jnp.int32)
    is_acgt = (rc == 65) | (rc == 67) | (rc == 71) | (rc == 84)
    big = rvalid & ((rl >= 64) | ~is_acgt)
    n_big = jnp.sum(big.astype(jnp.int32)).astype(jnp.int32)
    packed8 = jnp.where(big | ~rvalid, 0,
                        (rl.astype(jnp.int32) << 2) | code).astype(jnp.uint8)
    bkey = jnp.where(big, ridx2, INT_MAX)
    _, big_idx, big_len, big_chr = jax.lax.sort(
        (bkey, ridx2, rl, rc), num_keys=1)
    # big-run overflow list truncated to a STATIC cap in-program, packed
    # (idx << 32 | len) + char and TIERED like the main run list: n_big
    # is usually tiny (thousands) while the old fixed L/64 cap shipped
    # ~5 MB of mostly-pad rows at the 100 Mchar config. A dynamic
    # slice-to-bucket on the host side would be its own jit program
    # (a cold compile). n_big > cap falls back to the full
    # arrays host-side (rare).
    big_cap = min(L, max(1024, L >> 6))
    with jax.enable_x64(True):
        big_pack = (big_idx.astype(jnp.int64) << 32) | \
            big_len.astype(jnp.int64)
    big_tiers = tuple(
        (jax.lax.dynamic_slice(big_pack, (0,), (t,)),
         jax.lax.dynamic_slice(big_chr, (0,), (t,)).astype(jnp.uint8))
        for t in _big_tier_sizes(big_cap))
    # static geometric prefixes of the packed run list: the merged runs
    # are compacted at the front, but R is data-dependent while download
    # cost follows the BUFFER size — the host fetches the smallest prefix
    # covering R (a device-side slice-to-R-bucket would be its own jit
    # program = a cold compile at the pipeline's very end)
    p8_tiers = tuple(jax.lax.dynamic_slice(packed8, (0,), (t,))
                     for t in _p8_tier_sizes(L))
    return (p8_tiers, big_tiers,
            rl, rc.astype(jnp.uint8),
            jnp.stack([n_groups, maxlen, n_big]))


def _p8_tier_sizes(L: int) -> list[int]:
    """Geometric prefix lengths [L, L/1.25, ... >= 2^16], at most 12
    tiers. The host fetches the smallest tier covering the R compacted
    runs; halving tiers would overshoot the download by up to 2x (e.g.
    18 MB fetched for a 13.4 MB run list at the 100 Mchar config)."""
    tiers = [L]
    while tiers[-1] > (1 << 16) and len(tiers) < 12:
        tiers.append(int(tiers[-1] / 1.25))
    return tiers


def _big_tier_sizes(L: int) -> list[int]:
    """Geometric prefix lengths for the big-run overflow list (starts at
    the big cap, >= 2^10, at most 8 tiers)."""
    tiers = [L]
    while tiers[-1] > (1 << 10) and len(tiers) < 8:
        tiers.append(int(tiers[-1] / 4))
    return tiers


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def _pow2_pad(x: int, cap: int) -> int:
    """Geometric padding bucket (utils/jaxcache ratio): stable jit shapes
    at a fraction of the pad waste of power-of-two rounding (pad waste is
    real time here — sorts, fills, and the host download all run over the
    padded length)."""
    from ..utils.jaxcache import bucket_size
    p = bucket_size(max(x, 1))
    return min(p, cap) if cap else p


def _cls_avals(h_pad: int, with_slot: bool):
    """ShapeDtypeStruct pytree matching group_dev's output dict (plus
    cls_of_slot once class_ranks_dev ran) — prewarm needs the exact tree."""
    from ..utils import prewarm
    i32 = jnp.int32
    v = lambda: prewarm.sds((h_pad,), i32)
    cls = dict(n_classes=prewarm.sds((), i32), pos=v(), length=v(),
               isa_next=v(), smaller=prewarm.sds((h_pad,), jnp.bool_),
               until_next=v(), size=v(), key_k=v(), member_head=v(),
               member_off=v(), gid_sorted=v(), order_sorted=v(),
               text_rank=v())
    if with_slot:
        cls["cls_of_slot"] = v()
    return cls


def merge_prewarm(h_pad: int, n_pad: int, rle_quirk: bool):
    """Fire the h/n-shaped merge programs concurrently the moment the head
    count is known (the pair-dependent tail programs follow in mini-waves
    once their counts exist). See utils/prewarm for the cold-compile
    rationale."""
    from ..utils import prewarm
    w = prewarm.Wave()
    if not prewarm.enabled():
        return w
    S, i32, u8 = prewarm.sds, jnp.int32, jnp.uint8
    sc = S((), i32)
    ih = S((h_pad,), i32)
    ih1 = S((h_pad + 1,), i32)
    inn = S((n_pad,), i32)
    w.add("fixup", fixup_dev, ih, ih, ih, sc, inn, h_pad=h_pad)
    w.add("tail_counts", tail_counts_dev, ih, ih, sc,
          h_pad=h_pad, n_pad=n_pad)
    w.add("group", group_dev, ih, ih, S((h_pad,), jnp.bool_), ih, ih,
          sc, sc, h_pad=h_pad)
    w.add("class_ranks", class_ranks_dev, _cls_avals(h_pad, False), inn,
          sc, sc, sc, h_pad=h_pad)
    w.add("head_sa", head_string_sa_dev, ih1, sc, h_pad=h_pad)
    w.add("rank_heads", rank_heads_dev, _cls_avals(h_pad, True), ih1,
          S((h_pad,), u8), ih, sc, h_pad=h_pad)
    w.add("tail_pairs", tail_pairs_count_dev, _cls_avals(h_pad, True),
          h_pad=h_pad)
    w.add("runs_emit", runs_emit_dev, _cls_avals(h_pad, True), ih, ih,
          S((h_pad + 2,), i32), inn, S((h_pad,), u8), inn, inn,
          S((n_pad,), u8), sc, sc,
          h_pad=h_pad, n_pad=n_pad, rle_quirk=rle_quirk)
    return w


def _pairs_avals(h_pad: int):
    from ..utils import prewarm
    i32 = jnp.int32
    v = lambda: prewarm.sds((h_pad,), i32)
    # ``total`` is int32 here: the orchestrator replaces the device int64
    # sum with a host-round-tripped int32 scalar before the tail stages
    # (an int64 aval would be canonicalized during AOT lowering while the
    # concrete int64 kept its type at dispatch — signature mismatch)
    return dict(bucket_pos=v(), n_buckets=prewarm.sds((), i32), cls_lo=v(),
                cls_hi=v(), bucket_of_class=v(), pair_lo=v(), pair_cnt=v(),
                total=prewarm.sds((), i32))


def merge_device(head_t, head_pos, head_len, head_smaller, head_char,
                 ref_sa, ref_isa, ref_bwt, h: int, n: int, sn: int, d: int,
                 rle_quirk: bool, want_counter: bool = True, wave=None):
    """Full downstream merge on device; returns (run_len, run_char) numpy.

    Inputs are device arrays: heads padded to h_pad (valid prefix h, stream
    order), reference index padded to n_pad. ``want_counter`` gates the
    counter download (an O(h) transfer) — the pipeline only needs it for
    the small-path debug artifact (ref :919-924). ``wave`` is an optional
    already-started merge_prewarm Wave (the scan fires it as soon as h is
    known, overlapping these compiles with its own tail).
    """
    from ..ops.ms_dense import _stage_timer
    from ..utils.xfer import get as _get, put_i32 as _put_i32
    mark = _stage_timer()
    # tail_good_dev packs (class key)*(n+1)+isa and a tie flag into one
    # int64 sort key: needs 2n(n+1) < 2^61. Far above any HBM-feasible
    # device-merge ref size (n_pad int32 rows alone would exceed the chip).
    assert n < (1 << 30), "device merge supports references < 2^30 chars"
    h_pad = int(head_t.shape[0])
    n_pad = int(ref_sa.shape[0])
    if wave is None:
        wave = merge_prewarm(h_pad, n_pad, rle_quirk)
    d_t = _put_i32(d)
    n_t = _put_i32(n)
    h_t = _put_i32(h)

    wave.ready("fixup")
    to_next, isa_next, succ = fixup_dev(head_t, head_pos, head_len, h_t,
                                        ref_isa, h_pad)
    mark("fixup", to_next)
    wave.ready("tail_counts")
    tails_cnt = tail_counts_dev(head_pos, to_next, h_t, h_pad, n_pad)
    wave.ready("group")
    cls = group_dev(head_pos, head_len, head_smaller, to_next, isa_next,
                    h_t, n_t, h_pad)
    mark("group", cls["member_off"])
    wave.ready("class_ranks")
    rank_to_head, sa_ord, cls_of_slot = class_ranks_dev(
        cls, ref_isa, h_t, d_t, n_t, h_pad)
    cls["cls_of_slot"] = cls_of_slot
    wave.ready("head_sa")
    head_to_rank = head_string_sa_dev(rank_to_head, h_t, h_pad)
    mark("head_string_sa", head_to_rank)
    wave.ready("rank_heads")
    final_rank, bwt_heads, succ_rank, member_rank_sorted = rank_heads_dev(
        cls, head_to_rank, head_char, succ, h_t, h_pad)
    slot_base = cls["member_off"]
    mark("rank_heads", final_rank)

    wave.ready("tail_pairs")
    pairs = tail_pairs_count_dev(cls, h_pad)
    total_pairs = int(_get(pairs["total"]))
    mark("tail_pairs_count(P=%d)" % total_pairs)
    p_pad = _pow2_pad(total_pairs + 1, 0)
    assert total_pairs < (1 << 31), \
        "tail pair volume exceeds the int32 device merge"
    # int32 scalar for the tail stages (see _pairs_avals); the int64 sum
    # already served its purpose (overflow-safe host fetch)
    pairs = dict(pairs, total=_put_i32(total_pairs))
    from ..utils import prewarm as _prewarm
    tg_wave = _prewarm.Wave()
    if _prewarm.enabled():
        S, i32 = _prewarm.sds, jnp.int32
        tg_wave.add("tail_good", tail_good_dev, _cls_avals(h_pad, True),
                    _pairs_avals(h_pad), S((h_pad,), i32), S((), i32),
                    S((), i32), h_pad=h_pad, p_pad=p_pad)
    tg_wave.ready("tail_good")
    counter, n_exact_d, exact_members_d, e_pidx, e_fnd, src_cls = \
        tail_good_dev(cls, pairs, slot_base, h_t, n_t, h_pad, p_pad)
    # one batched fetch — each separate device_get is a full host round
    # trip
    n_exact, exact_members = (int(v) for v in
                              _get((n_exact_d, exact_members_d)))
    mark("tail_good(exact=%d)" % n_exact, counter)
    if n_exact:
        e_pad = _pow2_pad(n_exact, 0)
        em_pad = _pow2_pad(exact_members, 0)
        counter = tail_exact_dev(
            counter, cls, pairs, slot_base, member_rank_sorted, cls_of_slot,
            e_pidx, e_fnd, src_cls, _put_i32(n_exact), h_t,
            h_pad, e_pad, em_pad)
        mark("tail_exact", counter)

    wave.ready("runs_emit")
    (p8_tiers, big_tiers, rl_d, rc_d,
     scalars) = runs_emit_dev(
        cls, sa_ord, slot_base, counter, tails_cnt,
        bwt_heads,
        ref_sa, ref_isa, ref_bwt, d_t, n_t, h_pad, n_pad, rle_quirk)
    n_nz, maxlen, n_big = (int(v) for v in _get(scalars))
    mark("runs_emit(R=%d,big=%d)" % (n_nz, n_big))
    # prefix-tier download + host slicing: fetch the smallest static
    # prefix that covers the R compacted runs
    L_full = int(p8_tiers[0].shape[0])
    big_cap = min(L_full, max(1024, L_full >> 6))
    if n_big <= big_cap:
        # 1 byte/run; runs with len >= 64 or a non-ACGT char come from
        # the compacted packed (idx << 32 | len, char) overflow tiers
        tier = 0
        for i, t in enumerate(_p8_tier_sizes(L_full)):
            if t >= n_nz:
                tier = i
        p_np = _get(p8_tiers[tier])[:n_nz]
        rl = (p_np >> 2).astype(np.int64)
        rc = _ACGT[p_np & 3]
        if n_big:
            btier = 0
            for i, t in enumerate(_big_tier_sizes(big_cap)):
                if t >= n_big:
                    btier = i
            bp_np = _get(big_tiers[btier][0])[:n_big]
            bc_np = _get(big_tiers[btier][1])[:n_big]
            bi_np = (bp_np >> 32).astype(np.int64)
            rl[bi_np] = bp_np & 0xFFFFFFFF
            rc[bi_np] = bc_np
    else:
        rl = _get(rl_d)[:n_nz].astype(np.int64)
        rc = _get(rc_d)[:n_nz]
    mark("runs_download")
    # counterSmallerThanHead, slot-indexed (debug artifact parity,
    # ref :919-924); host layout is int64[h+1]
    counter_np = (_get(counter)[: h + 1].astype(np.int64)
                  if want_counter else None)
    return rl, rc, counter_np


def merge_heads_device_resident(dres, d: int, rle_quirk: bool,
                                want_counter: bool = True, wave=None):
    """Merge a DeviceHeadsResult (ops/ms_dense.ms_dense_heads_on_device)
    without any host round-trip: the head records and reference index are
    already device arrays in merge layout (zero pads)."""
    from ..utils.jaxcache import enable_compilation_cache
    _check_sn(int(dres.sn))
    enable_compilation_cache()
    return merge_device(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, dres.n, dres.sn, d, rle_quirk, want_counter=want_counter,
        wave=wave)


def merge_heads_numpy(head_t, head_pos, head_len, head_smaller, head_char,
                      ref_sa, ref_isa, ref_bwt, h: int, n: int, sn: int,
                      d: int, rle_quirk: bool, want_counter: bool = True):
    """Pad + upload numpy head records / reference index and run the device
    merge (the adapter the pipeline uses for DenseHeadsResult inputs).

    Shapes are padded to the shared geometric buckets (utils/jaxcache) so
    repeated runs and nearby sizes reuse compiled executables.
    """
    import jax.numpy as jnp

    _check_sn(int(sn))
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    enable_compilation_cache()
    h_pad = bucket_size(h + 1)
    n_pad = bucket_size(n + 1)

    def pad(a, size, dt, fill=0):
        out = np.full(size, fill, dt)
        out[: len(a)] = a
        return jnp.asarray(out)

    from ..ops.ms_dense import _stage_timer
    mark = _stage_timer()
    mark("merge_pad_upload_begin")
    res = merge_device(
        pad(head_t, h_pad, np.int32),
        pad(head_pos, h_pad, np.int32),
        pad(head_len, h_pad, np.int32),
        pad(head_smaller, h_pad, bool),
        pad(head_char, h_pad, np.uint8),
        pad(ref_sa, n_pad, np.int32),
        pad(ref_isa, n_pad, np.int32),
        pad(ref_bwt, n_pad, np.uint8),
        h, n, sn, d, rle_quirk, want_counter=want_counter)
    return res
