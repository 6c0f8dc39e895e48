"""Seeded prefix-doubling suffix sort for the joint (reference ++ collection)
string — the hot kernel of the dense MS backend.

The generic doubling pipeline (index/device.py) seeds at window 1 and pays
two ``lax.sort`` passes per doubling round. The joint string built by
ops/ms_dense has byte structure we can exploit (ref chars < 128, separators
all byte 2, pads a dedicated byte), so the first THREE rounds collapse into
ONE two-key sort:

* key 1: the next 8 bytes packed into a uint64, with every byte after the
  window's FIRST special (separator/pad) masked to 0. Specials are pairwise
  distinct symbols in the true joint alphabet, so the true comparison is
  decided no later than the first special — masking keeps the byte order
  from consulting later positions before the instance rank does;
* key 2: the instance rank of that first special (0 if none in the window).
  Two windows that tie on both keys either are byte-identical with no
  special (a true window-8 tie, refined by later rounds) or share the same
  first-special instance — i.e. they are the same window.

The caller must guarantee the joint string ENDS with a special (ms_dense
bumps the pad bucket otherwise): then any window reaching past the end
contains a special first, and past-end bytes never influence a key.

Doubling then starts at window 8. LCP lifting needs window-equality tests
at every level; levels >= 3 use the stored dense-rank history, and the
remaining sub-8 bits come from ONE byte-compare of the seed window packs
(``byte8_lcp``) — two gathers replace the six of the former fingerprint
levels. Each round also records, per SA position, the level at which its
left boundary first appeared (``split_lv``): rank-group ranges are
position-stable under refinement, so the final adjacent lcp lies in
[2^(L-1), 2^L) and the lift can start each pair at its own level.
Replaces the ``libsais()`` call of the reference
(ref CMS-BWT-functions.cpp:246-247) on the dense path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..index.device import n_levels

SEED_LEVEL = 3        # byte seed resolves windows of 2^3 = 8 bytes
WIDE_SEED_LEVEL = 5   # 4-bit coarse-code seed resolves 2^5 = 32 symbols
INT32_MAX = 2**31 - 1


def seed_level_of(packs) -> int:
    """The seed window level is carried by the pack layout: one int64 row
    = byte-8 seed, two rows = 4-bit 32-symbol seed."""
    return SEED_LEVEL if packs.shape[0] == 1 else WIDE_SEED_LEVEL


@functools.partial(jax.jit, static_argnames=("m", "wide"))
def joint_suffix_array(b: jnp.ndarray, sp: jnp.ndarray, m: int,
                       wide: bool = False):
    """Suffix sort of the joint string.

    The joint symbol at i IS the pair (b[i], sp[i]) ordered
    lexicographically — byte first, instance rank second. No scaled
    integer encoding exists anywhere (the old ``char * (S+1) + instance``
    int32 map capped the document count at ~8M; the pair form has no cap).

    b  uint8[m]  byte image: real char value, separators 2, pads 255
    sp int32[m]  instance rank (>= 1) for specials, 0 for real chars;
                 monotone within each special kind

    Returns (sa, isa, hist, pack8, k_star, split_lv):

    * ``hist[r]`` is the rank of windows of 2^(r+3). Ranks are
      POSITION-ranks (the global start position of the element's rank
      group) rather than dense ids — order-equivalent for every
      comparison, and the group start position doubles as the group's
      identity, which is what lets late rounds refine a compacted slice
      without renumbering the world;
    * ``pack8`` (int64[m], TEXT order) is the seed's masked 8-byte window
      pack — the sub-8 LCP oracle consumed by the byte-compare tail of the
      lifts (replaces the old f1 fingerprint levels);
    * ``k_star`` is the first level with fully distinct ranks (max
      pairwise lcp < 2^k_star) == max(split_lv);
    * ``split_lv`` (int32[m], SA order) records, per SA position r >= 1,
      the level at which the boundary between sa[r-1] and sa[r] first
      appeared. Rank groups occupy POSITION-STABLE ranges under
      refinement (refining only reorders within groups), so a boundary's
      position never moves once created, and
      ``lcp(sa[r-1], sa[r]) in [2^(L-1), 2^L)`` for L = split_lv[r] > 3
      (L == 3 only bounds the lcp to < 8). This is what lets the lift
      start each pair at its own top level instead of at k_star.

    Late rounds run COMPACTED: once the number of unresolved elements
    drops to u <= m/16, a round extracts the non-singleton groups with
    one 2-operand sort and refines only that slice (the long tail of
    deep ties — a handful of giant repeats — no longer costs full-array
    sort passes per round). Everything stays inside this one jit: the
    branch is a lax.switch, shapes are static.
    """
    sl = WIDE_SEED_LEVEL if wide else SEED_LEVEL
    assert m < (1 << 30), "rank+flag payload packing assumes m < 2^30"
    levels = n_levels(m)
    idx = jnp.arange(m, dtype=jnp.int32)
    # compacted-round capacity (static). m/16 measured best at the bench
    # regimes: raising it to 3m/8 (to absorb the ~30 % unresolved after
    # window 128) cost more in compacted-round machinery than the saved
    # full round (joint_sa 1.42 s -> 1.96 s at the 20 Mchar config)
    U = min(m, max(64, m // 16))

    if wide:
        assert m < (1 << 26), "wide seed packs (idx,byte,sp) in 60 bits"
        with jax.enable_x64(True):
            # --- 4-bit coarse symbol codes: ACGT -> odd 1/3/5/7, any
            # other byte ("stop") -> even 2*c with c = #ACGT bytes below
            # it. Coarse codes order a stop against every ACGT symbol
            # exactly; two stops tying on position+coarse-code resolve
            # via the v key (actual byte, then instance rank) — exact
            # because the caller guarantees every non-ACGT real byte
            # occurs at most once globally and sep/pad instances are
            # pairwise distinct (ms_dense._dense_core's wide_ok gate).
            bi32 = b.astype(jnp.int32)
            is_acgt = (b == 65) | (b == 67) | (b == 71) | (b == 84)
            code = jnp.where(
                is_acgt,
                2 * ((bi32 >= 67).astype(jnp.int32)
                     + (bi32 >= 71) + (bi32 >= 84)) + 1,
                2 * ((bi32 > 65).astype(jnp.int32)
                     + (bi32 > 67) + (bi32 > 71) + (bi32 > 84))
            ).astype(jnp.uint8)
            # first stop at-or-after each position, payload (byte, sp)
            idx64 = idx.astype(jnp.int64)
            BIGV = jnp.int64(1) << 62
            stop_val = jnp.where(
                ~is_acgt,
                (idx64 << 34) | (b.astype(jnp.int64) << 26)
                | sp.astype(jnp.int64), BIGV)
            nxt = jax.lax.cummin(stop_val[::-1])[::-1]
            d = jnp.where(nxt < BIGV, (nxt >> 34) - idx64, jnp.int64(32))
            v = jnp.where(d < 32, nxt & ((jnp.int64(1) << 34) - 1),
                          jnp.int64(0))
            # --- two 16-nibble keys, masked after the first stop ---
            cc = jnp.concatenate([code, jnp.zeros(32, jnp.uint8)])
            d32 = d.astype(jnp.int32)
            p1 = jnp.zeros(m, jnp.uint64)
            p2 = jnp.zeros(m, jnp.uint64)
            for k in range(16):
                ck = jax.lax.dynamic_slice(cc, (k,), (m,))
                ck = jnp.where(jnp.int32(k) <= d32, ck, jnp.uint8(0))
                p1 = (p1 << jnp.uint64(4)) | ck.astype(jnp.uint64)
            for k in range(16, 32):
                ck = jax.lax.dynamic_slice(cc, (k,), (m,))
                ck = jnp.where(jnp.int32(k) <= d32, ck, jnp.uint8(0))
                p2 = (p2 << jnp.uint64(4)) | ck.astype(jnp.uint64)
            sgn = jnp.uint64(1) << 63
            key1 = jax.lax.bitcast_convert_type(p1 ^ sgn, jnp.int64)
            key2 = jax.lax.bitcast_convert_type(p2 ^ sgn, jnp.int64)
            packs = jnp.stack([key1, key2])
            k1s, k2s_, v_s, ord_s = jax.lax.sort((key1, key2, v, idx),
                                                 num_keys=3)
            ch_b = jnp.concatenate(
                [jnp.ones(1, bool),
                 (k1s[1:] != k1s[:-1]) | (k2s_[1:] != k2s_[:-1])
                 | (v_s[1:] != v_s[:-1])])
    else:
        with jax.enable_x64(True):
            # --- first special (separator/pad) at-or-after each position
            sp64 = sp.astype(jnp.int64)
            BIGV = jnp.int64(1) << 62
            packed = jnp.where(sp64 > 0,
                               (idx.astype(jnp.int64) << 32) | sp64, BIGV)
            # flip+forward+flip: reverse=True cumulative lowering is ~8x
            # slower to compile (device_merge._rev_fill_min)
            nxt = jax.lax.cummin(packed[::-1])[::-1]
            d = jnp.where(nxt < BIGV, (nxt >> 32) - idx.astype(jnp.int64),
                          jnp.int64(8))  # distance to first special
            v = jnp.where(d < 8, nxt & jnp.int64(0xFFFFFFFF),
                          0).astype(jnp.int32)
            # --- seed key 1: 8 packed bytes, MASKED after the first
            # special. The true symbol comparison is decided no later
            # than the first special (instances are pairwise distinct),
            # so bytes past it are irrelevant — and must be zeroed, or
            # the byte order would consult them before the instance rank
            # (key 2). Byte-wide slices (the uint64 form read 8x the HBM
            # bytes per pass).
            bb = jnp.concatenate([b, jnp.zeros(8, jnp.uint8)])
            d32 = d.astype(jnp.int32)
            p8 = jnp.zeros(m, jnp.uint64)
            for k in range(8):
                bk = jax.lax.dynamic_slice(bb, (k,), (m,))
                bk = jnp.where(jnp.int32(k) <= d32, bk, jnp.uint8(0))
                p8 = (p8 << jnp.uint64(8)) | bk.astype(jnp.uint64)
            pack8 = jax.lax.bitcast_convert_type(p8, jnp.int64)
            packs = pack8[None, :]
            key = jax.lax.bitcast_convert_type(
                p8 ^ jnp.uint64(1 << 63), jnp.int64)  # order-keeping cast
            k_s, v_s, ord_s = jax.lax.sort((key, v, idx), num_keys=2)
            ch_b = jnp.concatenate(
                [jnp.ones(1, bool),
                 (k_s[1:] != k_s[:-1]) | (v_s[1:] != v_s[:-1])])
    split_lv = jnp.where(ch_b, jnp.int32(sl), 0)
    # position-ranks + per-element resolved flag (singleton group), packed
    # into ONE payload for the inversion sort (sort cost scales with
    # operand count; rank < m < 2^30 leaves room for the flag bit)
    seed_rank_s = jax.lax.cummax(jnp.where(ch_b, idx, -1))
    sing_s = ch_b & jnp.concatenate([ch_b[1:], jnp.ones(1, bool)])
    _, packed_rs = jax.lax.sort(
        (ord_s, (seed_rank_s << 1) | sing_s.astype(jnp.int32)), num_keys=1)
    rank = packed_rs >> 1
    resolved = (packed_rs & 1) != 0
    u0 = (m - jnp.sum(sing_s.astype(jnp.int32))).astype(jnp.int32)

    # quadrupling rounds: each sort refines by TWO doubling levels at once
    # — keys (rank, rank@+w) and (rank@+2w, rank@+3w) packed into two int64
    # sort keys. A 2-key sort costs ~1.25x a 1-key sort (measured) but
    # replaces two full rounds (2 sorts each), so the doubling phase runs in
    # about half the passes. Both refined rank rows (window 2w and 4w) are
    # recovered from the ONE sorted order, so the LCP lift still has every
    # level's rank history.
    ks = list(range(sl, levels - 1, 2))
    n_hist = max((ks[-1] - sl + 2) + 1 if ks else 1, 1)
    hist = jnp.zeros((n_hist, m), jnp.int32).at[0].set(rank)

    def shifted(r, shift):
        # clamp: a shift >= m must yield all -1 (the padding region)
        shift = jnp.minimum(shift, jnp.int32(m))
        padded = jnp.concatenate([r, jnp.full(m, -1, jnp.int32)])
        return jax.lax.dynamic_slice(padded, (shift,), (m,))

    def round_k(carry, k):
        (rank, sa, hist, lv, resolved, u, comp_ran,
         ti_c, rank_c, live_c) = carry
        w = jnp.int32(1) << k

        def do_full(args):
            rank, sa, lv, resolved = args
            r1 = shifted(rank, w)
            r2 = shifted(rank, 2 * w)
            r3 = shifted(rank, 3 * w)
            with jax.enable_x64(True):
                kk1 = (rank.astype(jnp.int64) << 32) | \
                    (r1.astype(jnp.int64) + 1)
                kk2 = ((r2.astype(jnp.int64) + 1) << 32) | \
                    (r3.astype(jnp.int64) + 1)
                kk1_s, kk2_s, o_s = jax.lax.sort((kk1, kk2, idx),
                                                 num_keys=2)
                ch_mid_b = jnp.concatenate(
                    [jnp.ones(1, bool), kk1_s[1:] != kk1_s[:-1]])
                ch_full_b = ch_mid_b | jnp.concatenate(
                    [jnp.ones(1, bool), kk2_s[1:] != kk2_s[:-1]])
            # record first-appearance levels of the new boundaries (group
            # ranges are position-stable, so sorted coords == final coords)
            lv = jnp.where(ch_mid_b & (lv == 0), k + 1, lv)
            lv = jnp.where(ch_full_b & (lv == 0), k + 2, lv)
            mid_sorted = jax.lax.cummax(jnp.where(ch_mid_b, idx, -1))
            full_sorted = jax.lax.cummax(jnp.where(ch_full_b, idx, -1))
            sing = ch_full_b & jnp.concatenate(
                [ch_full_b[1:], jnp.ones(1, bool)])
            # inversion sort with ONE packed payload (ranks < m < 2^30)
            with jax.enable_x64(True):
                pk = (mid_sorted.astype(jnp.int64) << 31) | \
                    (full_sorted.astype(jnp.int64) << 1) | \
                    sing.astype(jnp.int64)
                _, pk_t = jax.lax.sort((o_s, pk), num_keys=1)
                mid_rank = (pk_t >> 31).astype(jnp.int32)
                full_rank = ((pk_t >> 1) &
                             ((jnp.int64(1) << 30) - 1)).astype(jnp.int32)
                res = (pk_t & 1) != 0
            u_new = (m - jnp.sum(sing.astype(jnp.int32))).astype(jnp.int32)
            return (mid_rank, full_rank, o_s, lv, res, u_new,
                    jnp.zeros((), bool), ti_c, rank_c, live_c)

        def do_comp(args):
            # refine ONLY the u unresolved elements: extract them grouped
            # by current rank (ONCE — later rounds reuse the carried slice:
            # the unresolved set only shrinks, so the full-m extraction
            # sort is paid a single time, not per round), sort the slice by
            # the quad keys, renumber within groups (rank == group start
            # position, so new rank = group rank + local offset), scatter
            # the updates back
            rank, sa, lv, resolved = args

            def extract(_):
                ckey = jnp.where(resolved, INT32_MAX, rank)
                ck_s, ti_all = jax.lax.sort((ckey, idx), num_keys=1)
                grp0 = jax.lax.dynamic_slice(ck_s, (0,), (U,))
                return (jax.lax.dynamic_slice(ti_all, (0,), (U,)),
                        grp0, grp0 < INT32_MAX)

            ti, grp, live = jax.lax.cond(
                comp_ran, lambda _: (ti_c, rank_c, live_c), extract,
                operand=None)
            tic = jnp.clip(ti, 0, m - 1)

            def sh(off):
                at = tic + off
                vv = rank[jnp.clip(at, 0, m - 1)]
                return jnp.where(live & (at < m), vv, -1)

            r1, r2, r3 = sh(w), sh(2 * w), sh(3 * w)
            urow = jnp.arange(U, dtype=jnp.int32)
            with jax.enable_x64(True):
                kk1 = jnp.where(live, (grp.astype(jnp.int64) << 32)
                                | (r1.astype(jnp.int64) + 1),
                                jnp.int64(1) << 62)
                kk2 = ((r2.astype(jnp.int64) + 1) << 32) | \
                    (r3.astype(jnp.int64) + 1)
                kk1_s, kk2_s, rowsrc = jax.lax.sort((kk1, kk2, urow),
                                                    num_keys=2)
                g_hi = (kk1_s >> 32).astype(jnp.int32)
                is_g = jnp.concatenate(
                    [jnp.ones(1, bool), g_hi[1:] != g_hi[:-1]])
                is_mid = is_g | jnp.concatenate(
                    [jnp.ones(1, bool), kk1_s[1:] != kk1_s[:-1]])
                is_full = is_mid | jnp.concatenate(
                    [jnp.ones(1, bool), kk2_s[1:] != kk2_s[:-1]])
                live_s = kk1_s < (jnp.int64(1) << 62)
            g_row = jax.lax.cummax(jnp.where(is_g, urow, -1))
            mid_row = jax.lax.cummax(jnp.where(is_mid, urow, -1))
            full_row = jax.lax.cummax(jnp.where(is_full, urow, -1))
            mid_rank_u = g_hi + (mid_row - g_row)
            full_rank_u = g_hi + (full_row - g_row)
            # new boundaries: subgroup starts that are not group starts;
            # those positions were never boundaries before, so plain set
            dump = jnp.int32(m)
            lv = lv.at[jnp.where(live_s & is_mid & ~is_g,
                                 mid_rank_u, dump)].set(k + 1, mode="drop")
            lv = lv.at[jnp.where(live_s & is_full & ~is_mid,
                                 full_rank_u, dump)].set(k + 2, mode="drop")
            # member resolution: full-subgroup of size 1
            sing = is_full & jnp.concatenate(
                [is_full[1:], jnp.ones(1, bool)])
            ti_s = ti[jnp.clip(rowsrc, 0, U - 1)]
            at = jnp.where(live_s, ti_s, dump)
            mid_rank_text = rank.at[at].set(mid_rank_u, mode="drop")
            rank = rank.at[at].set(full_rank_u, mode="drop")
            resolved = resolved.at[at].set(sing, mode="drop")
            u_new = jnp.sum((live_s & ~sing).astype(jnp.int32)) \
                .astype(jnp.int32)
            # carry the refined slice forward: next compacted round reuses
            # it instead of re-extracting with a full-m sort
            return (mid_rank_text, rank, sa, lv, resolved, u_new,
                    jnp.ones((), bool), ti_s, full_rank_u,
                    live_s & ~sing)

        def do_skip(args):
            rank, sa, lv, resolved = args
            return (rank, rank, sa, lv, resolved, jnp.int32(0),
                    jnp.zeros((), bool), ti_c, rank_c, live_c)

        branch = jnp.where(u == 0, 0, jnp.where(u <= U, 2, 1))
        (mid_rank, full_rank, sa, lv, resolved, u, comp_now,
         ti_c, rank_c, live_c) = jax.lax.switch(
            branch, [do_skip, do_full, do_comp], (rank, sa, lv, resolved))
        comp_ran = comp_ran | comp_now
        hist = hist.at[k - sl + 1].set(mid_rank)
        hist = hist.at[k - sl + 2].set(full_rank)
        return (full_rank, sa, hist, lv, resolved, u, comp_ran,
                ti_c, rank_c, live_c), None

    sa0 = jnp.zeros(m, jnp.int32)
    (rank, sa, hist, split_lv, resolved, u, comp_ran, _tc, _rc,
     _lc), _ = jax.lax.scan(
        round_k, (rank, sa0, hist, split_lv, resolved, u0,
                  jnp.zeros((), bool), jnp.zeros(U, jnp.int32),
                  jnp.zeros(U, jnp.int32), jnp.zeros(U, bool)),
        jnp.asarray(ks, dtype=jnp.int32))

    # sa: the last FULL round's order is stale wherever a compacted round
    # refined further (and the seed-resolved case never produced one) —
    # invert the final position-ranks in those cases
    def invert(_):
        _, s = jax.lax.sort((rank, idx), num_keys=1)
        return s

    sa = jax.lax.cond(comp_ran | (u0 == 0), invert, lambda a: a, sa)
    k_star = jnp.max(split_lv)
    return sa, rank, hist, packs, k_star, split_lv


def byte8_lcp(pa, pb):
    """Common SYMBOL-prefix length (< 8) of two masked 8-byte window packs
    (int64, first char in the high byte). Two symbols match iff their
    bytes are equal AND neither is a special (bytes 2/255): distinct
    suffixes never share a special instance, so a special always ends the
    match. Elementwise byte unpacking — no table gathers."""
    with jax.enable_x64(True):
        out = jnp.zeros(pa.shape, jnp.int32)
        eq_so_far = jnp.ones(pa.shape, bool)
        for t in range(8):
            sh = 56 - 8 * t
            ba = (pa >> sh) & jnp.int64(0xFF)
            bb = (pb >> sh) & jnp.int64(0xFF)
            sp = (ba == 2) | (ba == 255) | (bb == 2) | (bb == 255)
            eq_so_far = eq_so_far & (ba == bb) & ~sp
            out = out + eq_so_far.astype(jnp.int32)
    return out


def nib16_lcp(pa, pb):
    """Common SYMBOL-prefix length (<= 16) of two masked 16-nibble coarse
    packs (wide seed). A nibble match counts only when both are ODD
    (real ACGT symbols): even nibbles are stops, and two distinct
    suffixes never share a stop symbol (unique bytes / distinct
    instances), so a stop always ends the match."""
    with jax.enable_x64(True):
        out = jnp.zeros(pa.shape, jnp.int32)
        eq_so_far = jnp.ones(pa.shape, bool)
        for t in range(16):
            sh = 60 - 4 * t
            na = (pa >> sh) & jnp.int64(0xF)
            nb = (pb >> sh) & jnp.int64(0xF)
            eq_so_far = eq_so_far & (na == nb) & ((na & 1) == 1)
            out = out + eq_so_far.astype(jnp.int32)
    return out


def pack_lcp_at(packs, ai, bi, m: int):
    """Sub-seed-window lcp of suffix pair (ai, bi) from the seed packs:
    byte-8 compare for the narrow layout, two 16-nibble compares for the
    wide one (the second consulted only when the first fully matches)."""
    def g(r, at):
        return packs[r][jnp.clip(at, 0, m - 1)]

    if packs.shape[0] == 1:
        return byte8_lcp(g(0, ai), g(0, bi))
    r0 = nib16_lcp(g(0, ai), g(0, bi))
    r1 = nib16_lcp(g(1, ai), g(1, bi))
    return r0 + jnp.where(r0 == 16, r1, 0)


def lift_pairs(hist, packs, ai, bi, lv, m: int):
    """lcp(ai, bi) for SA-adjacent index pairs by binary lifting.

    ``lv`` is each pair's boundary split level (see joint_suffix_array):
    the lift starts at h = 2^(lv-1) — guaranteed matched — and descends
    the rank history to the seed level; the final sub-window bits come
    from the seed-pack compare at the resolved offset. Tests at levels
    above a pair's own range are exact (they simply fail), so the shared
    loop bound is max(lv) - 2. Invalid entries carry ai >= m."""
    sl = seed_level_of(packs)
    valid = (ai < m) & (bi < m)
    lmax = jnp.max(jnp.where(valid, lv, 0))
    h = jnp.where(valid & (lv > sl),
                  jnp.int32(1) << jnp.maximum(lv - 1, 0), 0)

    def gath(arr, at):
        return arr[jnp.clip(at, 0, m - 1)]

    def body(i, h):
        k = lmax - 2 - i
        rk = jax.lax.dynamic_index_in_dim(
            hist, jnp.maximum(k - sl, 0), 0, keepdims=False)
        va = ai + h
        vb = bi + h
        ok = valid & (va < m) & (vb < m)
        eq = ok & (gath(rk, va) == gath(rk, vb))
        return h + jnp.where(eq, jnp.int32(1) << k, 0)

    h = jax.lax.fori_loop(
        0, jnp.maximum(lmax - 2 - sl + 1, 0), body, h)
    rem = pack_lcp_at(packs, ai + h, bi + h, m)
    return h + jnp.where(valid, rem, 0)
