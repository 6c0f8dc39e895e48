"""Dense matching statistics: one joint suffix sort of (reference ++
collection) replaces the per-character scan entirely.

Rationale (SURVEY.md §2 parallelism table): sorts and scans stream at
memory bandwidth, while the reference's pointer-chasing scan
(ref ``CMS-BWT-functions.cpp:45-149``) is a chain of dependent random
gathers. So the scan is reformulated as dense array passes, and every O(m)
permutation is applied by *sorting* rather than by an m-element scatter
(whether a direct scatter or gather is cheaper on the GPU awaits
measurement):

1. Joint int32 string J = map(x) ++ map(SX) where collection separators get
   distinct ascending values in (1, 3)·(S+1) — exactly the reference's
   implicit ordering of document separators (doc-rank order, ref :630-645).
2. Prefix-doubling suffix sort of J (two lax.sorts per round; rank history
   kept for lifting).
3. Adjacent joint LCP via the irreducible-PLCP theorem (Kärkkäinen–Manzini–
   Puglisi): only SA slots whose preceding characters differ (joint-BWT run
   boundaries) are lifted through the rank history; the rest follow from a
   ``cummax`` fill — O(runs · log m) gathers instead of O(m · log m).
4. For every collection suffix, the nearest reference suffixes above/below
   in joint order and the LCP to each (segmented min scans — by the
   range-min property these equal lcp(suffix, neighbor) exactly). Then

   * ``mslen  = max(A, B)``  (A/B = LCP to nearest ref below/above),
   * ``smaller = B >= A``    (the reference picks the successor when it
     shares the maximal prefix, ref :62-76),
   * ``pos    = succ if B >= A else pred``

   which reproduces ``computeMSFactorAt``'s (pos, len, smaller) exactly —
   including insertion-point tie rules — because the reference's choice *is*
   the joint-order neighbor rule.

The ref-only SA/ISA/BWT fall out of the joint order by compaction, so this
one pipeline subsumes the separate index build for the scan-free path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SEPARATOR

INT_MIN = -(2**31)
INT_MAX = 2**31 - 1
LV_BINS = 34               # split-level histogram bins (levels < 32 + spill)


from ..utils.xfer import get as _get, put as _put, put_i32 as _put_i32


def _joint_sa(b: jnp.ndarray, sp: jnp.ndarray, m: int,
              wide: bool = False):
    """Seeded doubling sort (ops/joint_sa.py); returns
    (sa, isa, hist, packs, k_star, split_lv). ``wide`` selects the
    32-symbol 4-bit seed (requires the wide_ok precondition — see
    _dense_core)."""
    from .joint_sa import joint_suffix_array
    return joint_suffix_array(b, sp, m, wide)


# --- 2-bit ACGT transport packing -----------------------------------------
#
# O(sn) bytes cross the host-device link. Genomic collections are almost
# entirely A/C/G/T: the host packs 4 chars/byte and ships the rare
# non-ACGT bytes (document separators, the reference's
# alphabet-augmentation tail, sentinels) as a tiny (position, value)
# exception list; the device unpacks with elementwise shifts — no
# gathers.

_PACK_CODE = np.full(256, 255, np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _PACK_CODE[_ch] = _i


def _pack2_host(arr: np.ndarray, valid_len: int):
    """2-bit-pack ``arr`` (length already padded to its jit bucket).

    Only the first ``valid_len`` entries are inspected — pad bytes unpack
    as 'A' and are overwritten by the pad logic on device. Returns
    (packed_u8, exc_pos_i32, exc_val_u8), or None when exceptions exceed
    ~1.5% of the valid prefix (raw upload is cheaper then)."""
    codes = _PACK_CODE[arr[:valid_len]]
    exc = np.flatnonzero(codes == 255)
    if len(exc) > max(1024, valid_len >> 6):
        return None
    if len(exc):
        codes[exc] = 0
    L4 = -(-len(arr) // 4)
    c = np.zeros(L4 * 4, np.uint8)
    c[:valid_len] = codes
    c = c.reshape(L4, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed, exc.astype(np.int32), arr[exc]


def _unpack2(q: jnp.ndarray, out_pad: int) -> jnp.ndarray:
    """packed uint8[ceil(out_pad/4)] -> ACGT bytes uint8[out_pad]."""
    c = jnp.stack([q & 3, (q >> 2) & 3, (q >> 4) & 3, (q >> 6) & 3],
                  axis=1).reshape(-1)[:out_pad].astype(jnp.int32)
    # branch-free code->byte: 65 + 2c + 2*[c>=2] + 11*[c==3] = A/C/G/T
    return (65 + 2 * c + 2 * (c >= 2).astype(jnp.int32)
            + 11 * (c == 3).astype(jnp.int32)).astype(jnp.uint8)


def _build_joint_core(x_u8, sx_u8, n, sn, sep_base, n_pad: int, sn_pad: int):
    """Joint-string construction body (shared by the raw and packed entry
    points).

    sep_base = number of separators before this block (global numbering).

    Returns (b, sp): the joint symbol at i IS the pair (b[i], sp[i]) —
    real chars keep their byte with sp 0, separators share byte 2 with
    doc-order instance ranks, pads share byte 255 with ascending ranks
    (distinct pads resolve at window 1; constant pads would stall early
    convergence). No scaled integer symbol exists, so the document count
    is unbounded (the old ``char*(S+1)`` int32 map capped it at ~8M).
    """
    ridx = jnp.arange(n_pad, dtype=jnp.int32)
    is_xpad = ridx >= n
    bx = jnp.where(is_xpad, jnp.uint8(255), x_u8)
    spx = jnp.where(is_xpad, ridx + 1, 0).astype(jnp.int32)
    tidx = jnp.arange(sn_pad, dtype=jnp.int32)
    is_sep = (tidx < sn) & (sx_u8 == SEPARATOR)
    sep_rank = jnp.cumsum(is_sep.astype(jnp.int32)) - 1
    is_tpad = tidx >= sn
    bsx = jnp.where(is_tpad, jnp.uint8(255),
                    jnp.where(is_sep, jnp.uint8(SEPARATOR), sx_u8))
    spsx = jnp.where(is_tpad, n_pad + tidx + 1,
                     jnp.where(is_sep, sep_base + sep_rank + 1, 0)
                     ).astype(jnp.int32)
    return (jnp.concatenate([bx, bsx]), jnp.concatenate([spx, spsx]))


@functools.partial(jax.jit, static_argnames=("n_pad", "sn_pad"))
def _build_joint_device(x_u8, sx_u8, n, sn, sep_base,
                        n_pad: int, sn_pad: int):
    """Raw-byte entry point (non-ACGT-heavy inputs)."""
    return _build_joint_core(x_u8, sx_u8, n, sn, sep_base, n_pad, sn_pad)


@functools.partial(jax.jit,
                   static_argnames=("n_pad", "sn_pad", "e_pad"))
def _build_joint_device_packed(xq, sxq, exc_pos, exc_val, n, sn, sep_base,
                               n_pad: int, sn_pad: int, e_pad: int):
    """2-bit-packed entry point: unpack both parts, restore the non-ACGT
    exceptions (positions are global over the concatenated [x | sx] image;
    pad slots carry an out-of-range position and drop), then run the
    shared body."""
    cat = jnp.concatenate([_unpack2(xq, n_pad), _unpack2(sxq, sn_pad)])
    cat = cat.at[exc_pos].set(exc_val, mode="drop")
    return _build_joint_core(cat[:n_pad], cat[n_pad:], n, sn, sep_base,
                             n_pad, sn_pad)


@functools.partial(jax.jit, static_argnames=("m", "n_pad"))
def _irreducible_slots(b, sp, sa, isa, split_lv, n, sn, m: int,
                       n_pad: int):
    """Irreducible-LCP slots in SA order, compacted by sorting.

    Returns (stats, ai_sorted, bi_sorted, lv_sorted): the first rho
    entries of the sorted arrays are the irreducible slots' text position
    sa[r], φ value sa[r-1], and boundary split level. Pairs come out
    sorted by split level DESCENDING (ties by slot), so a lift step for
    hist level k touches exactly the prefix of pairs with lv >= k+2.
    ``stats`` packs [rho, histogram of lv] into one int32 vector for a
    single host fetch. Pad text positions are excluded — their (distinct)
    ramp symbols would make every pad slot irreducible, and their PLCP
    values are never consumed: each real region re-anchors at its own
    irreducible (any position preceded by a pad char is itself
    irreducible).
    """
    # joint BWT in SA order via one sort: payload v[i] = symbol (b, sp)
    # pair of i-1 packed int64 (equality only — no order semantics needed)
    with jax.enable_x64(True):
        sym = (sp.astype(jnp.int64) << 8) | b.astype(jnp.int64)
        v = jnp.concatenate([jnp.full(1, -1, jnp.int64), sym[:-1]])
        _, bw_sa = jax.lax.sort((isa, v), num_keys=1)
        bw_prev = jnp.concatenate([jnp.full(1, -2, jnp.int64), bw_sa[:-1]])
    r = jnp.arange(m, dtype=jnp.int32)
    reducible = (r > 0) & (bw_sa >= 0) & (bw_sa == bw_prev)
    is_real = (sa < n) | ((sa >= n_pad) & (sa < n_pad + sn))
    irr = ~reducible & is_real
    rho = jnp.sum(irr.astype(jnp.int32))
    sa_prev = jnp.concatenate([jnp.full(1, m, jnp.int32), sa[:-1]])
    with jax.enable_x64(True):
        lvc = jnp.clip(split_lv, 0, LV_BINS - 2)
        key = jnp.where(irr, ((LV_BINS - lvc.astype(jnp.int64)) << 32)
                        | r.astype(jnp.int64), jnp.int64(1) << 62)
        key_s, ai, bi = jax.lax.sort((key, sa, sa_prev), num_keys=1)
        # recover the level from the sorted key (one payload saved) and the
        # level histogram by searchsorted over the sorted high field — a
        # colliding scatter-add histogram serializes at gather speed
        lvp = jnp.where(key_s < (jnp.int64(1) << 62),
                        LV_BINS - (key_s >> 32).astype(jnp.int32), 0)
        bounds = ((LV_BINS - jnp.arange(LV_BINS, dtype=jnp.int64)) << 32)
        starts = jnp.searchsorted(key_s, bounds)
        ends = jnp.searchsorted(key_s, bounds + (jnp.int64(1) << 32))
        hist_lv = (ends - starts).astype(jnp.int32)
    stats = jnp.concatenate([rho[None], hist_lv])
    return stats, ai, bi, lvp


@functools.partial(jax.jit, static_argnames=("m", "rho_pad"))
def _lift_and_fill(hist, packs, ai_all, bi_all, lv_all, isa, m: int,
                   rho_pad: int):
    """Lift lcp(ai, bi) for the first rho_pad compacted pairs, fill PLCP
    for all text positions, and return the adjacent joint LCP in SA order.

    Single-dispatch variant (used inside shard_map, where per-level host
    orchestration is impossible): every pair runs the shared level loop.
    The production single-device path uses the compacted per-level stepper
    below instead."""
    from .joint_sa import lift_pairs
    ai = jax.lax.dynamic_slice(ai_all, (0,), (rho_pad,))
    bi = jax.lax.dynamic_slice(bi_all, (0,), (rho_pad,))
    lv = jax.lax.dynamic_slice(lv_all, (0,), (rho_pad,))
    h = lift_pairs(hist, packs, ai, bi, lv, m)
    return _fill_ell(h, ai, isa, m, rho_pad)


@functools.partial(jax.jit, static_argnames=("m", "rho_pad"))
def _fill_ell(h, ai, isa, m: int, rho_pad: int):
    """Scatter pair lcps to text order, cummax-fill PLCP, re-sort to SA
    order (the shared tail of both lift variants)."""
    valid = ai < m
    base = jnp.full(m, INT_MIN, jnp.int32).at[
        jnp.where(valid, ai, m)].set(
        jnp.where(valid, h, INT_MIN), mode="drop")
    r = jnp.arange(m, dtype=jnp.int32)
    best = jax.lax.cummax(jnp.where(base > INT_MIN, base + r, INT_MIN))
    plcp = best - r
    # PLCP (text order) -> adjacent LCP in SA order via one sort
    _, ell = jax.lax.sort((isa, plcp), num_keys=1)
    ell = ell.at[0].set(0)
    return ell


@functools.partial(jax.jit, static_argnames=("m", "rho_pad", "seed_level"))
def _lift_start(ai_all, bi_all, lv_all, m: int, rho_pad: int,
                seed_level: int = 3):
    """Slice the pair prefix and seed h = 2^(lv-1) (guaranteed matched —
    the pair's boundary split at level lv, so lcp >= 2^(lv-1))."""
    ai = jax.lax.dynamic_slice(ai_all, (0,), (rho_pad,))
    bi = jax.lax.dynamic_slice(bi_all, (0,), (rho_pad,))
    lv = jax.lax.dynamic_slice(lv_all, (0,), (rho_pad,))
    valid = (ai < m) & (bi < m)
    h = jnp.where(valid & (lv > seed_level),
                  jnp.int32(1) << jnp.maximum(lv - 1, 0), 0)
    return ai, bi, h


@functools.partial(jax.jit,
                   static_argnames=("m", "c_pad", "seed_level"))
def _lift_level_step(h, ai, bi, hist, k, m: int, c_pad: int,
                     seed_level: int = 3):
    """One descent level for the first c_pad pairs (those with lv >= k+2;
    the caller sizes c_pad from the level histogram — pairs are sorted by
    lv descending, so the active set is a prefix). Gathers scale with the
    ACTIVE pair count, not rho: at typical SNP rates most pairs have small
    lcps and the deep levels run on tiny prefixes."""
    hc = jax.lax.dynamic_slice(h, (0,), (c_pad,))
    ac = jax.lax.dynamic_slice(ai, (0,), (c_pad,))
    bc = jax.lax.dynamic_slice(bi, (0,), (c_pad,))
    rk = jax.lax.dynamic_index_in_dim(
        hist, jnp.maximum(k - seed_level, 0), 0, keepdims=False)
    va = ac + hc
    vb = bc + hc
    ok = (ac < m) & (bc < m) & (va < m) & (vb < m)
    eq = ok & (rk[jnp.clip(va, 0, m - 1)] == rk[jnp.clip(vb, 0, m - 1)])
    hc = hc + jnp.where(eq, jnp.int32(1) << k, 0)
    return jax.lax.dynamic_update_slice(h, hc, (0,))


@functools.partial(jax.jit, static_argnames=("m", "rho_pad"))
def _lift_bytes_fill(h, ai, bi, packs, isa, m: int, rho_pad: int):
    """Resolve the sub-seed-window lcp bits with a compare of the seed
    packs, then fill (the orchestrated path's tail)."""
    from .joint_sa import pack_lcp_at
    valid = (ai < m) & (bi < m)
    h = h + jnp.where(valid, pack_lcp_at(packs, ai + h, bi + h, m), 0)
    return _fill_ell(h, ai, isa, m, rho_pad)


def _lift_orchestrated(hist, packs, ai_all, bi_all, lv_all, isa,
                       rho_stats, m: int, rho_pad: int):
    """Host-orchestrated leveled lift: one small dispatch per hist level,
    each over the bucketed prefix of pairs still in range (lv >= k+2).
    rho_stats = host copy of the _irreducible_slots stats vector."""
    from ..utils import prewarm
    from ..utils.jaxcache import bucket_size
    from .joint_sa import seed_level_of
    sl = seed_level_of(packs)
    hist_lv = rho_stats[1:]
    live = np.nonzero(hist_lv)[0]
    lmax = int(live.max()) if len(live) else 0
    # (k, c_pad) schedule first, so every level program compiles
    # concurrently before the serial dispatch chain starts
    sched = []
    for k in range(lmax - 2, sl - 1, -1):
        cnt = int(hist_lv[k + 2:].sum())
        if cnt:
            sched.append((k, min(bucket_size(cnt), rho_pad)))
    wave = prewarm.Wave()
    if prewarm.enabled():
        S, i32 = prewarm.sds, jnp.int32
        im = S((m,), i32)
        ir = S((rho_pad,), i32)
        hv = S(tuple(hist.shape), jnp.int32)
        wave.add("start", _lift_start, im, im, im, m=m, rho_pad=rho_pad,
                 seed_level=sl)
        for c_pad in sorted({c for _, c in sched}):
            wave.add(f"lv{c_pad}", _lift_level_step, ir, ir, ir, hv,
                     S((), i32), m=m, c_pad=c_pad, seed_level=sl)
        wave.add("fill", _lift_bytes_fill, ir, ir, ir,
                 S(tuple(packs.shape), jnp.int64),
                 im, x64=True, m=m, rho_pad=rho_pad)
    wave.ready("start")
    ai, bi, h = _lift_start(ai_all, bi_all, lv_all, m, rho_pad,
                            seed_level=sl)
    for k, c_pad in sched:
        wave.ready(f"lv{c_pad}")
        h = _lift_level_step(h, ai, bi, hist, _put_i32(k), m, c_pad,
                             seed_level=sl)
    wave.ready("fill")
    return _lift_bytes_fill(h, ai, bi, packs, isa, m, rho_pad)


def _seg_min_scan(vals, reset, reverse=False):
    """Segmented running min via one ``cummax`` (associative_scan's generic
    lowering OOMs the compiler at tens of millions of elements).

    With segment ids s[r] = cumsum(reset), the segmented min equals
    ``BIG*s[r] - cummax(BIG*s - vals)[r]``: earlier segments' transformed
    values are smaller by at least BIG - range(vals) so they never win.
    """
    if reverse:
        return _seg_min_scan(vals[::-1], reset[::-1])[::-1]
    with jax.enable_x64(True):  # int64 survives canonicalization in-scope
        big = jnp.int64(1) << 32
        seg = jnp.cumsum(reset.astype(jnp.int64))
        t = big * seg - vals.astype(jnp.int64)
        out = (big * seg - jax.lax.cummax(t)).astype(jnp.int32)
    return out


def _fill_ref_value(is_ref, sa, m, reverse=False):
    """Nearest reference slot's sa value at-or-below (or at-or-above with
    reverse) each slot, plus an existence mask — one packed cummax."""
    if reverse:
        v, ok = _fill_ref_value(is_ref[::-1], sa[::-1], m)
        return v[::-1], ok[::-1]
    with jax.enable_x64(True):
        idx = jnp.arange(is_ref.shape[0], dtype=jnp.int64)
        packed = jnp.where(is_ref, (idx << 32) | sa.astype(jnp.int64),
                           jnp.int64(-1))
        f = jax.lax.cummax(packed)
        ok = f >= 0
        val = (f & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
    return val, ok


@functools.partial(jax.jit, static_argnames=("m",))
def _neighbors(sa, ell, n, m: int):
    """For each joint SA slot: (pred ref pos, succ ref pos, A, B).

    A[r] (resp. B[r]) is lcp(suffix at slot r, nearest ref suffix below
    (resp. above)) — the segmented min of adjacent LCPs equals the endpoint
    lcp by the range-min property. ``n`` is traced so bucket-padded shapes
    share one compilation.
    """
    is_ref = sa < n
    pred_pos, has_pred = _fill_ref_value(is_ref, sa, m)
    succ_pos, has_succ = _fill_ref_value(is_ref, sa, m, reverse=True)

    reset_fwd = jnp.concatenate([jnp.ones(1, bool), is_ref[:-1]])
    a = _seg_min_scan(ell, reset_fwd)
    ell_s = jnp.concatenate([ell[1:], jnp.zeros(1, jnp.int32)])
    reset_bwd = jnp.concatenate([is_ref[1:], jnp.ones(1, bool)])
    b = _seg_min_scan(ell_s, reset_bwd, reverse=True)
    b = jnp.where(has_succ, b, INT_MIN)
    a = jnp.where(has_pred, a, INT_MIN)
    return pred_pos, jnp.where(has_succ, succ_pos, -1), a, b


@functools.partial(jax.jit, static_argnames=("m", "n_pad", "sn_pad"))
def _assemble(sa, pred_pos, succ_pos, a, b, n, sn, m: int, n_pad: int,
              sn_pad: int):
    """Sort per-slot results into collection text order + extract the
    reference-only index (bucket-padded output shapes; sliced on host)."""
    r = jnp.arange(m, dtype=jnp.int32)
    is_ref = sa < n
    is_coll = (sa >= n_pad) & (sa < n_pad + sn)
    choose_succ = b >= a
    pos_slot = jnp.where(choose_succ, succ_pos, pred_pos)
    len_slot = jnp.maximum(a, b)
    # collection text order via sort (t is a permutation of [0, sn));
    # (pos, len, smaller) share one packed payload — pos/len < 2^30
    t = sa - n_pad
    key = jnp.where(is_coll, t, INT_MAX)
    with jax.enable_x64(True):
        pls = (pos_slot.astype(jnp.int64) << 31) | \
            (jnp.clip(len_slot, 0, (1 << 30) - 1).astype(jnp.int64) << 1) \
            | choose_succ.astype(jnp.int64)
        _, pls_txt = jax.lax.sort((key, pls), num_keys=1)
        pls_t = jax.lax.dynamic_slice(pls_txt, (0,), (sn_pad,))
        pos = (pls_t >> 31).astype(jnp.int32)
        length = ((pls_t >> 1) & ((jnp.int64(1) << 30) - 1)) \
            .astype(jnp.int32)
        smaller = (pls_t & 1) != 0
    # reference extraction: ref slots in SA order, then invert by sorting
    key_ref = jnp.where(is_ref, r, INT_MAX)
    _, ref_sa_full = jax.lax.sort((key_ref, sa), num_keys=1)
    ref_sa = jax.lax.dynamic_slice(ref_sa_full, (0,), (n_pad,))
    ridx = jnp.arange(n_pad, dtype=jnp.int32)
    key_inv = jnp.where(ridx < n, ref_sa, INT_MAX)
    _, ref_isa = jax.lax.sort((key_inv, ridx), num_keys=1)
    return pos, length, smaller, ref_sa, ref_isa


@functools.partial(jax.jit, static_argnames=("n_pad", "sn_pad"))
def _postprocess(b, pos, length, smaller, n, sn,
                 n_pad: int, sn_pad: int):
    """Device-side separator fixup, head detection, and bucket counts.

    Only O(n + H) data leaves the device afterwards.
    """
    bc = jax.lax.dynamic_slice(b, (n_pad,), (sn_pad,))
    tidx = jnp.arange(sn_pad, dtype=jnp.int32)
    valid = tidx < sn
    sep = valid & (bc == SEPARATOR)
    pos = jnp.where(sep, n - 1, pos)
    length = jnp.where(sep, 0, length)
    prev = jnp.concatenate([jnp.full(1, -2, jnp.int32), pos[:-1]])
    is_head = valid & (pos != prev + 1)
    smaller = smaller & is_head & ~sep
    # one combined scatter-add for both count arrays
    # bucket counts are NOT computed here: every device scatter variant
    # serializes at a few M elem/s; the merge engine derives tail counts
    # from head records (to_next spans) on the host instead
    h = jnp.sum(is_head.astype(jnp.int32))
    # head BWT char: previous collection char, cyclic (extract_heads rule);
    # separators are literally byte 2 in the byte image, so the char IS
    # the previous byte (no scaled recovery)
    prev_b = jnp.concatenate([bc[:1], bc[:-1]])
    prev_b = jnp.where(tidx == 0, bc[jnp.maximum(sn - 1, 0)], prev_b)
    return pos, length, smaller, is_head, h, prev_b


@functools.partial(jax.jit, static_argnames=("sn_pad", "h_pad"))
def _compact_heads(pos, length, smaller, is_head, char,
                   sn_pad: int, h_pad: int):
    """Order-preserving head compaction via one multi-operand sort."""
    tidx = jnp.arange(sn_pad, dtype=jnp.int32)
    key = jnp.where(is_head, tidx, INT_MAX)
    _, t_s, pos_s, len_s, sml_s, chr_s = jax.lax.sort(
        (key, tidx, pos, length, smaller.astype(jnp.int32),
         char.astype(jnp.int32)), num_keys=1)
    sl = lambda x: jax.lax.dynamic_slice(x, (0,), (h_pad,))
    return sl(t_s), sl(pos_s), sl(len_s), sl(sml_s) != 0, sl(chr_s)


@dataclass
class DenseMSResult:
    pos: np.ndarray
    length: np.ndarray
    smaller: np.ndarray
    is_head: np.ndarray
    # extracted reference-only index (for the downstream merge engine)
    ref_sa: np.ndarray
    ref_isa: np.ndarray
    ref_bwt: np.ndarray
    irreducible: int
    m: int


@dataclass
class DenseHeadsResult:
    """Head records + bucket counts + reference index — everything the
    downstream merge engine needs, with only O(n + H) host transfer."""

    head_t: np.ndarray
    head_pos: np.ndarray
    head_len: np.ndarray
    head_smaller: np.ndarray
    head_char: np.ndarray
    ref_sa: np.ndarray
    ref_isa: np.ndarray
    ref_bwt: np.ndarray
    h: int
    sn: int
    irreducible: int



class _SepCounter:
    """Incremental separators-before-position counter.

    np.cumsum over a 100M-element mask measures ~13 s single-core on the
    bench host (numpy's pairwise cumsum path); per-block count_nonzero is
    SIMD and O(block). Block starts are non-decreasing across the loop
    (retries re-enter with the same b0).
    """

    def __init__(self, sx):
        self.sx = sx
        self.pos = 0
        self.cnt = 0

    def before(self, b0: int) -> int:
        if b0 < self.pos:
            self.pos = 0
            self.cnt = 0
        if b0 > self.pos:
            self.cnt += int(np.count_nonzero(
                self.sx[self.pos:b0] == SEPARATOR))
            self.pos = b0
        return self.cnt


def _pow2_pad(x: int) -> int:
    return 1 << max(4, int(np.ceil(np.log2(max(x, 1)))))


_stage_timer_state = {"t": 0.0}


def _stage_timer():
    """Optional per-stage sync timing (CMSBWT_PROFILE=1). All timer
    instances share one clock: a nested pipeline stage's timer must not
    restart the caller's elapsed window (its first mark would otherwise
    re-report the whole callee runtime)."""
    import os
    import sys
    import time
    if not os.environ.get("CMSBWT_PROFILE"):
        return lambda name, *arrs: None
    state = _stage_timer_state
    state["t"] = time.time()

    def mark(name, *arrs):
        # block_until_ready, NOT a 1-element download: a slice fetch can
        # return before the producing program finishes, which charges
        # whole stages to their successors
        for a in arrs:
            try:
                jax.block_until_ready(a)
            except Exception as e:
                print(f"#   mark({name}) block FAILED: {e!r}",
                      file=sys.stderr)
        now = time.time()
        print(f"#   {name}: {(now - state['t']) * 1e3:.0f} ms",
              file=sys.stderr)
        state["t"] = now
    return mark


def _scan_prewarm(n_pad: int, sn_pad: int, m: int,
                  pack_e_pad: int | None = None, wide: bool = False):
    """Wave A: every scan program whose shapes are known from (n, sn)
    alone, fired concurrently at entry (utils/prewarm rationale).
    ``pack_e_pad`` selects the 2-bit-packed build program (its exception
    bucket) instead of the raw-byte one; ``wide`` the 32-symbol seed."""
    from ..utils import prewarm
    from .joint_sa import joint_suffix_array
    w = prewarm.Wave()
    if not prewarm.enabled():
        return w
    S, i32, u8 = prewarm.sds, jnp.int32, jnp.uint8
    sc = S((), i32)
    im = S((m,), i32)
    if pack_e_pad is not None:
        w.add("build", _build_joint_device_packed,
              S((-(-n_pad // 4),), u8), S((-(-sn_pad // 4),), u8),
              S((pack_e_pad,), i32), S((pack_e_pad,), u8),
              sc, sc, sc, n_pad=n_pad, sn_pad=sn_pad, e_pad=pack_e_pad)
    else:
        w.add("build", _build_joint_device, S((n_pad,), u8),
              S((sn_pad,), u8), sc, sc, sc, n_pad=n_pad, sn_pad=sn_pad)
    w.add("jsa", joint_suffix_array, S((m,), u8), im, m=m, wide=wide)
    w.add("irr", _irreducible_slots, S((m,), u8), im, im, im, im,
          sc, sc, m=m, n_pad=n_pad)
    w.add("nbr", _neighbors, im, im, sc, m=m)
    w.add("asm", _assemble, im, im, im, im, im, sc, sc,
          m=m, n_pad=n_pad, sn_pad=sn_pad)
    w.add("post", _postprocess, S((m,), u8), S((sn_pad,), i32),
          S((sn_pad,), i32), S((sn_pad,), jnp.bool_), sc, sc,
          n_pad=n_pad, sn_pad=sn_pad)
    return w


def _dense_core(x_aug: np.ndarray, sx: np.ndarray, bucketed: bool):
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    enable_compilation_cache()
    mark = _stage_timer()
    n = len(x_aug)
    sn = len(sx)
    n_pad = bucket_size(n) if bucketed else n
    sn_pad = bucket_size(sn) if bucketed else sn
    # the seeded sort requires the joint string to end with a special
    # (pad or separator) — see ops/joint_sa.py
    if sn_pad == sn and (sn == 0 or sx[-1] != SEPARATOR):
        sn_pad = bucket_size(sn + 1) if bucketed else sn + 1
    m = n_pad + sn_pad
    n_t = _put_i32(n)
    sn_t = _put_i32(sn)
    x_u8 = np.zeros(n_pad, np.uint8)
    x_u8[:n] = x_aug
    sx_u8 = np.zeros(sn_pad, np.uint8)
    sx_u8[:sn] = sx
    px = _pack2_host(x_u8, n)
    psx = _pack2_host(sx_u8, sn)
    wide = False
    if px is not None and psx is not None:
        exc_pos = np.concatenate([px[1], psx[1] + np.int32(n_pad)])
        exc_val = np.concatenate([px[2], psx[2]])
        # wide-seed precondition: every non-ACGT real byte occurs at most
        # once globally (separators carry instance ranks, so byte 2 in
        # the collection is exempt) — then the 32-symbol coarse seed's
        # stop ties always resolve exactly (ops/joint_sa.py wide branch)
        chk = np.concatenate([px[2], psx[2][psx[2] != SEPARATOR]])
        wide = (m < (1 << 26)
                and len(chk) == len(np.unique(chk)))
        e_pad = _pow2_pad(len(exc_pos) + 1)
        ep = np.full(e_pad, n_pad + sn_pad, np.int32)  # pads drop (OOB)
        ep[:len(exc_pos)] = exc_pos
        ev = np.zeros(e_pad, np.uint8)
        ev[:len(exc_val)] = exc_val
        wave = _scan_prewarm(n_pad, sn_pad, m, pack_e_pad=e_pad,
                             wide=wide)
        wave.ready("build")
        b, sp = _build_joint_device_packed(
            _put(px[0]), _put(psx[0]), _put(ep), _put(ev),
            n_t, sn_t, _put_i32(0), n_pad, sn_pad, e_pad)
        x_dev = None   # consumers gather ref bytes from b's prefix
    else:
        wave = _scan_prewarm(n_pad, sn_pad, m)
        x_dev = _put(x_u8)
        wave.ready("build")
        b, sp = _build_joint_device(x_dev, _put(sx_u8),
                                    n_t, sn_t, _put_i32(0),
                                    n_pad, sn_pad)
    mark("upload+build_joint", b)

    wave.ready("jsa")
    sa, isa, hist, packs, k_star, split_lv = _joint_sa(b, sp, m, wide)
    mark("joint_sa", sa)
    wave.ready("irr")
    stats_dev, ai_all, bi_all, lv_all = _irreducible_slots(
        b, sp, sa, isa, split_lv, n_t, sn_t, m, n_pad)
    stats = _get(stats_dev)
    rho = int(stats[0])
    mark("irreducible(rho=%d)" % rho, ai_all)
    rho_pad = min(_pow2_pad(rho), m)
    ell = _lift_orchestrated(hist, packs, ai_all, bi_all, lv_all, isa,
                             stats, m, rho_pad)
    mark("lift_and_fill", ell)
    wave.ready("nbr")
    pred_pos, succ_pos, av, bv = _neighbors(sa, ell, n_t, m)
    mark("neighbors", av)
    wave.ready("asm")
    pos, length, smaller, ref_sa, ref_isa = _assemble(
        sa, pred_pos, succ_pos, av, bv, n_t, sn_t, m, n_pad, sn_pad)
    mark("assemble", pos)
    core_d = dict(b=b, n=n, sn=sn, n_pad=n_pad, sn_pad=sn_pad, m=m, rho=rho,
                  n_t=n_t, sn_t=sn_t, pos=pos, length=length,
                  smaller=smaller, ref_sa=ref_sa, ref_isa=ref_isa,
                  x_dev=x_dev, wave=wave)
    return core_d


def _export_ref(core) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = core["n"]
    ref_sa = np.asarray(core["ref_sa"])[:n]
    ref_isa = np.asarray(core["ref_isa"])[:n]
    return ref_sa, ref_isa


def ms_dense(x_aug: np.ndarray, sx: np.ndarray,
             bucketed: bool = True) -> DenseMSResult:
    """Full dense MS computation returning per-position arrays (test and
    small-input path; production uses ms_dense_heads)."""
    core = _dense_core(x_aug, sx, bucketed)
    n, sn = core["n"], core["sn"]
    core["wave"].ready("post")
    (pos, length, smaller, is_head, h_dev,
     char) = _postprocess(core["b"], core["pos"], core["length"],
                          core["smaller"], core["n_t"], core["sn_t"],
                          core["n_pad"], core["sn_pad"])
    pos_np = np.asarray(pos)[:sn].astype(np.int64)
    length_np = np.asarray(length)[:sn].astype(np.int64)
    smaller_np = np.asarray(smaller)[:sn].copy()
    is_head_np = np.asarray(is_head)[:sn].copy()
    ref_sa, ref_isa = _export_ref(core)
    x_aug_np = np.asarray(x_aug)
    ref_bwt = np.where(ref_sa > 0, x_aug_np[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    return DenseMSResult(pos=pos_np, length=length_np, smaller=smaller_np,
                         is_head=is_head_np, ref_sa=ref_sa, ref_isa=ref_isa,
                         ref_bwt=ref_bwt, irreducible=core["rho"],
                         m=core["m"])


def ms_dense_heads(x_aug: np.ndarray, sx: np.ndarray,
                   bucketed: bool = True) -> DenseHeadsResult:
    """Dense MS with device-side head extraction (the production path)."""
    mark = _stage_timer()
    core = _dense_core(x_aug, sx, bucketed)
    n, sn = core["n"], core["sn"]
    core["wave"].ready("post")
    (pos, length, smaller, is_head, h_dev,
     char) = _postprocess(core["b"], core["pos"], core["length"],
                          core["smaller"], core["n_t"], core["sn_t"],
                          core["n_pad"], core["sn_pad"])
    h = int(np.asarray(h_dev))
    mark("postprocess", pos)
    h_pad = min(_pow2_pad(h), core["sn_pad"])
    out_t, out_pos, out_len, out_sml, out_chr = _compact_heads(
        pos, length, smaller, is_head, char,
        core["sn_pad"], h_pad)
    mark("compact_heads", out_t)
    ref_sa, ref_isa = _export_ref(core)
    x_aug_np = np.asarray(x_aug)
    ref_bwt = np.where(ref_sa > 0, x_aug_np[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    mark("ref_export_download", ref_sa)
    return DenseHeadsResult(
        head_t=np.asarray(out_t)[:h].astype(np.int64),
        head_pos=np.asarray(out_pos)[:h].astype(np.int64),
        head_len=np.asarray(out_len)[:h].astype(np.int64),
        head_smaller=np.asarray(out_sml)[:h],
        head_char=np.asarray(out_chr)[:h].astype(np.uint8),
        ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, sn=sn, irreducible=core["rho"])


@dataclass
class DeviceHeadsResult:
    """Device-resident form of DenseHeadsResult: head records (h_pad, zero
    pads beyond h) and reference index (n_pad, zero pads beyond n) stay on
    the device, in the exact layout engine/device_merge.py consumes —
    nothing O(n) or O(H) crosses the host link between the scan and the
    merge."""

    head_t: jnp.ndarray        # int32[h_pad]
    head_pos: jnp.ndarray      # int32[h_pad]
    head_len: jnp.ndarray      # int32[h_pad]
    head_smaller: jnp.ndarray  # bool[h_pad]
    head_char: jnp.ndarray     # uint8[h_pad]
    ref_sa: jnp.ndarray        # int32[n_pad]
    ref_isa: jnp.ndarray       # int32[n_pad]
    ref_bwt: jnp.ndarray       # uint8[n_pad]
    h: int
    n: int
    sn: int
    irreducible: int


@functools.partial(jax.jit, static_argnames=("h_pad", "n_pad"))
def _finish_for_merge(t, pos, length, smaller, char, ref_sa, ref_isa,
                      b_joint, n, h, h_pad: int, n_pad: int):
    """Zero-fill pads (the merge kernels assume zeroed pad regions, matching
    merge_heads_numpy's np.full fill) and compute the reference BWT on
    device (ref CMS-BWT-functions.cpp:294-297). ``b_joint`` is the joint
    byte image — its [0, n) prefix IS the reference text (ms_dense never
    keeps a separate x upload on the packed path)."""
    x_dev = jax.lax.dynamic_slice(b_joint, (0,), (n_pad,))
    def hpad(a, fill):
        src = a.shape[0]
        if src < h_pad:
            a = jnp.concatenate(
                [a, jnp.full(h_pad - src, fill, a.dtype)])
        return jax.lax.dynamic_slice(a, (0,), (h_pad,))

    hid = jnp.arange(h_pad, dtype=jnp.int32)
    keep = hid < h
    t = jnp.where(keep, hpad(t, 0), 0)
    pos = jnp.where(keep, hpad(pos, 0), 0)
    length = jnp.where(keep, hpad(length, 0), 0)
    smaller = jnp.where(keep, hpad(smaller, False), False)
    char = jnp.where(keep, hpad(char, 0), 0).astype(jnp.uint8)

    rid = jnp.arange(n_pad, dtype=jnp.int32)
    rkeep = rid < n
    ref_sa = jnp.where(rkeep, ref_sa, 0)
    ref_isa = jnp.where(rkeep, ref_isa, 0)
    xp = jnp.concatenate([x_dev, jnp.zeros(1, jnp.uint8)])
    ref_bwt = jnp.where(rkeep & (ref_sa > 0),
                        xp[jnp.clip(ref_sa - 1, 0, n_pad - 1)],
                        jnp.uint8(0))
    return t, pos, length, smaller, char, ref_sa, ref_isa, ref_bwt


def ms_dense_heads_on_device(x_aug: np.ndarray, sx: np.ndarray,
                             bucketed: bool = True,
                             merge_hook=None) -> DeviceHeadsResult:
    """Dense MS whose result STAYS on device for the device merge engine
    (engine/device_merge.py): only the scalars (h, rho) reach the host.

    ``merge_hook(h_pad, n_pad)`` (optional) is called the moment the head
    count is known, BEFORE the compaction dispatches — the pipeline uses
    it to fire the merge engine's prewarm wave so those compiles overlap
    the scan's tail (utils/prewarm)."""
    from ..utils import prewarm
    from ..utils.jaxcache import bucket_size
    mark = _stage_timer()
    core = _dense_core(x_aug, sx, bucketed)
    n, sn = core["n"], core["sn"]
    core["wave"].ready("post")
    (pos, length, smaller, is_head, h_dev,
     char) = _postprocess(core["b"], core["pos"], core["length"],
                          core["smaller"], core["n_t"], core["sn_t"],
                          core["n_pad"], core["sn_pad"])
    h = int(_get(h_dev))
    mark("postprocess", pos)
    h_pad = bucket_size(h + 1)
    if merge_hook is not None:   # side effect: caller stores the wave
        merge_hook(h_pad, core["n_pad"])
    ch_pad = min(h_pad, core["sn_pad"] + 1)
    cwave = prewarm.Wave()
    if prewarm.enabled():
        S, i32, u8 = prewarm.sds, jnp.int32, jnp.uint8
        sn_pad, n_pad = core["sn_pad"], core["n_pad"]
        isn = S((sn_pad,), i32)
        cwave.add("compact", _compact_heads_raw, isn, isn,
                  S((sn_pad,), jnp.bool_), S((sn_pad,), jnp.bool_),
                  S((sn_pad,), u8), sn_pad=sn_pad, h_pad=ch_pad)
        cwave.add("finish", _finish_for_merge, S((ch_pad,), i32),
                  S((ch_pad,), i32), S((ch_pad,), i32),
                  S((ch_pad,), jnp.bool_), S((ch_pad,), i32),
                  S((n_pad,), i32), S((n_pad,), i32),
                  S((core["m"],), u8),
                  S((), i32), S((), i32), h_pad=h_pad, n_pad=n_pad)
    cwave.ready("compact")
    out_t, out_pos, out_len, out_sml, out_chr = _compact_heads_raw(
        pos, length, smaller, is_head, char,
        core["sn_pad"], ch_pad)
    mark("compact_heads", out_t)
    cwave.ready("finish")
    (t, pos_h, len_h, sml_h, chr_h, ref_sa, ref_isa,
     ref_bwt) = _finish_for_merge(
        out_t, out_pos, out_len, out_sml, out_chr,
        core["ref_sa"], core["ref_isa"], core["b"], core["n_t"],
        _put_i32(h), h_pad, core["n_pad"])
    mark("finish_for_merge", t)
    return DeviceHeadsResult(
        head_t=t, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=core["rho"])


@functools.partial(jax.jit, static_argnames=("sn_pad", "h_pad"))
def _compact_heads_raw(pos, length, smaller, is_head, char,
                       sn_pad: int, h_pad: int):
    """_compact_heads without the byte recovery (char stays a raw joint
    value; _finish_for_merge divides on the compacted slice)."""
    tidx = jnp.arange(sn_pad, dtype=jnp.int32)
    key = jnp.where(is_head, tidx, INT_MAX)
    _, t_s, pos_s, len_s, sml_s, chr_s = jax.lax.sort(
        (key, tidx, pos, length, smaller.astype(jnp.int32),
         char.astype(jnp.int32)), num_keys=1)
    sl = lambda x: jax.lax.dynamic_slice(x, (0,), (h_pad,))
    return sl(t_s), sl(pos_s), sl(len_s), sl(sml_s) != 0, sl(chr_s)


# ---------------------------------------------------------------------------
# Blocked execution: bounded memory + the unit of multi-chip distribution
# ---------------------------------------------------------------------------
#
# The collection is processed in fixed-size blocks with a right-context
# window. Exactness: every emitted quantity is an endpoint property —
# pred/succ are decided by suffix-vs-reference comparisons that resolve
# within mslen+1 chars, and A/B equal lcp(suffix, neighbor-ref) by the
# range-min identity, independent of the (possibly truncated) suffixes in
# between. A truncated match is detected on device (the match runs into the
# context boundary) and the block is retried with a doubled context. This
# is the device generalization of the reference's chunked spill
# (ref CMS-BWT-functions.cpp:1131-1416): blocks are independent, so they
# stream on one chip or fan out across a mesh.

class _BlockCheckpoints:
    """Per-block head persistence: blocked scans resume after a crash
    without recomputing finished blocks (restartable form of the reference's
    ``.phrases`` spill, ref CMS-BWT-functions.cpp:1135-1416)."""

    def __init__(self, directory: str, fingerprint: str, block_chars: int):
        from ..utils.checkpoint import CheckpointManager
        self.mgr = CheckpointManager(directory)
        self.fp = f"{fingerprint}:b{block_chars}"

    def load_block(self, b0: int):
        data = self.mgr.load(f"dense_block_{b0}", self.fp)
        if data is None:
            return None
        part = {k: data[k] for k in ("t", "pos", "length", "smaller", "char")}
        return dict(part=part, rho=int(data["rho"]),
                    last_pos=int(data["last_pos"]),
                    ref_sa=data.get("ref_sa"), ref_isa=data.get("ref_isa"))

    def save_block(self, b0: int, part: dict, rho: int, last_pos: int,
                   ref_sa=None, ref_isa=None) -> None:
        arrays = dict(part)
        arrays["rho"] = np.int64(rho)
        arrays["last_pos"] = np.int64(last_pos)
        if ref_sa is not None:
            arrays["ref_sa"] = ref_sa
            arrays["ref_isa"] = ref_isa
        self.mgr.save(f"dense_block_{b0}", self.fp, arrays)


def _block_ckpt(directory, fingerprint, block_chars):
    return (_BlockCheckpoints(directory, fingerprint or "", block_chars)
            if directory else None)


class _NullProgress:
    def update(self, chars: int) -> None:
        pass


def _block_progress(sn: int):
    """Throughput progress for blocked scans (blocks done, Mchars/s)."""
    try:
        from ..utils.logging import Progress, get_logger
        return Progress(get_logger(), sn)
    except Exception:
        return _NullProgress()


@functools.partial(jax.jit, static_argnames=("n_pad", "sn_pad"))
def _postprocess_block(b, pos, length, smaller, n, emit_len,
                       prev_pos0, prev_b0, n_pad: int, sn_pad: int):
    """Block variant of _postprocess: emits only [0, emit_len), takes the
    previous block's final pos and preceding char byte, and reports
    context-truncation violations."""
    bc = jax.lax.dynamic_slice(b, (n_pad,), (sn_pad,))
    tidx = jnp.arange(sn_pad, dtype=jnp.int32)
    valid = tidx < emit_len
    sep = valid & (bc == SEPARATOR)
    pos = jnp.where(sep, n - 1, pos)
    length = jnp.where(sep, 0, length)
    prev = jnp.concatenate([jnp.full(1, 0, jnp.int32), pos[:-1]])
    prev = jnp.where(tidx == 0, prev_pos0, prev)
    is_head = valid & (pos != prev + 1)
    smaller = smaller & is_head & ~sep
    # bucket counts are NOT computed here: every device scatter variant
    # serializes at a few M elem/s; the merge engine derives tail counts
    # from head records (to_next spans) on the host instead
    h = jnp.sum(is_head.astype(jnp.int32))
    prev_b = jnp.concatenate([bc[:1], bc[:-1]])
    char = jnp.where(tidx == 0, prev_b0.astype(jnp.uint8), prev_b)
    # truncation check: a match reaching within 2 chars of the loaded window
    # may have been cut by the pad (sn_block chars were loaded; pads are
    # byte 255, which never occurs in a valid collection)
    sn_block = jnp.sum((bc != jnp.uint8(255)).astype(jnp.int32))
    viol = jnp.any(valid & (tidx + length + 2 > sn_block))
    last_pos = pos[jnp.maximum(emit_len - 1, 0)]
    # one packed scalar vector so the host needs a single fetch per block
    scalars = jnp.stack([h, viol.astype(jnp.int32), last_pos])
    return (pos, length, smaller, is_head, char, scalars)


def ms_dense_heads_blocked(x_aug: np.ndarray, sx: np.ndarray,
                           block_chars: int, ctx_chars: int | None = None,
                           checkpoint_dir: str | None = None,
                           fingerprint: str | None = None
                           ) -> DenseHeadsResult:
    """Streaming/blocked dense MS: processes the collection in blocks of
    ``block_chars`` with an adaptive right-context (bounded memory; blocks
    are the distribution unit for multi-chip).

    With ``checkpoint_dir`` each completed block's compacted heads are
    persisted under (fingerprint, block) — a crash mid-scan resumes without
    recomputing finished blocks (the restartable generalization of the
    reference's ``.phrases`` spill, ref CMS-BWT-functions.cpp:1135-1416)."""
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    enable_compilation_cache()
    n = len(x_aug)
    sn = len(sx)
    if ctx_chars is None:
        ctx_chars = max(1 << 16, block_chars // 8)
    s_total = int(np.count_nonzero(sx == SEPARATOR))
    sep_cum = _SepCounter(sx)
    n_pad = bucket_size(n)
    ckpt = _block_ckpt(checkpoint_dir, fingerprint, block_chars)
    progress = _block_progress(sn)
    x_dev = None
    # prewarm the per-block programs for the canonical block bucket (the
    # same wave the unblocked core fires; _postprocess_block replaces
    # _postprocess here). Adaptive-context retries recompile, but every
    # regular block shares these shapes.
    bs_pad0 = bucket_size(block_chars + (ctx_chars or 0))
    wave = _scan_prewarm(n_pad, bs_pad0, n_pad + bs_pad0)
    from ..utils import prewarm as _prewarm
    if _prewarm.enabled():
        _S, _i32 = _prewarm.sds, jnp.int32
        wave.add("post_block", _postprocess_block,
                 _S((n_pad + bs_pad0,), jnp.uint8), _S((bs_pad0,), _i32),
                 _S((bs_pad0,), _i32), _S((bs_pad0,), jnp.bool_),
                 _S((), _i32), _S((), _i32), _S((), _i32), _S((), _i32),
                 n_pad=n_pad, sn_pad=bs_pad0)

    head_parts: list[dict] = []
    ref_sa = ref_isa = None
    prev_pos0 = -2
    prev_b0 = None  # byte of sx[b0-1] (separators are literally byte 2)
    total_rho = 0
    b0 = 0
    while b0 < sn:
        emit_len = min(block_chars, sn - b0)
        cached = ckpt.load_block(b0) if ckpt else None
        if cached is not None:
            head_parts.append(cached["part"])
            total_rho += cached["rho"]
            prev_pos0 = cached["last_pos"]
            if ref_sa is None and cached.get("ref_sa") is not None:
                ref_sa, ref_isa = cached["ref_sa"], cached["ref_isa"]
            prev_b0 = int(sx[b0 + emit_len - 1])
            b0 += emit_len
            progress.update(emit_len)
            continue
        if x_dev is None:
            x_u8 = np.zeros(n_pad, np.uint8)
            x_u8[:n] = x_aug
            x_dev = jnp.asarray(x_u8)      # reference uploaded once
        ctx = ctx_chars
        while True:
            end = min(b0 + emit_len + ctx, sn)
            sx_blk = sx[b0:end]
            # fixed bucket for every block (incl. the short last one) so all
            # blocks share one set of compiled shapes
            bs_pad = bucket_size(block_chars + ctx)
            if bs_pad == len(sx_blk) and sx_blk[-1] != SEPARATOR:
                bs_pad = bucket_size(bs_pad + 1)  # joint must end special
            m = n_pad + bs_pad
            # joint string built on device with GLOBAL separator numbering
            sx_u8 = np.zeros(bs_pad, np.uint8)
            sx_u8[: len(sx_blk)] = sx_blk
            sep_base = sep_cum.before(b0)
            wave.ready("build")
            b, sp = _build_joint_device(
                x_dev, jnp.asarray(sx_u8), jnp.int32(n),
                jnp.int32(len(sx_blk)),
                jnp.int32(sep_base), n_pad, bs_pad)
            n_t = jnp.int32(n)
            wave.ready("jsa")
            sa, isa, hist, packs, k_star, split_lv = _joint_sa(b, sp, m)
            wave.ready("irr")
            stats_dev, ai_all, bi_all, lv_all = _irreducible_slots(
                b, sp, sa, isa, split_lv, jnp.int32(n),
                jnp.int32(len(sx_blk)), m, n_pad)
            stats = _get(stats_dev)
            rho = int(stats[0])
            rho_pad = min(_pow2_pad(rho), m)
            ell = _lift_orchestrated(hist, packs, ai_all, bi_all, lv_all,
                                     isa, stats, m, rho_pad)
            wave.ready("nbr")
            pred_pos, succ_pos, av, bv = _neighbors(sa, ell, n_t, m)
            wave.ready("asm")
            pos, length, smaller, rsa, risa = _assemble(
                sa, pred_pos, succ_pos, av, bv, n_t,
                jnp.int32(len(sx_blk)), m, n_pad, bs_pad)
            # cyclic rule: the stream's first head char is the final char
            # of the collection — always the trailing separator (byte 2)
            pb0 = jnp.int32(SEPARATOR if prev_b0 is None else prev_b0)
            wave.ready("post_block")
            (pos, length, smaller, is_head, char,
             scalars) = _postprocess_block(
                b, pos, length, smaller, n_t, jnp.int32(emit_len),
                jnp.int32(prev_pos0), pb0,
                n_pad, bs_pad)
            h, viol, last_pos = (int(v) for v in np.asarray(scalars))
            if viol and end < sn:
                ctx *= 2
                continue
            break
        total_rho += rho
        h_pad = min(_pow2_pad(h), bs_pad)
        out_t, out_pos, out_len, out_sml, out_chr = _compact_heads(
            pos, length, smaller, is_head, char,
            bs_pad, h_pad)
        part = dict(
            t=np.asarray(out_t)[:h].astype(np.int64) + b0,
            pos=np.asarray(out_pos)[:h].astype(np.int64),
            length=np.asarray(out_len)[:h].astype(np.int64),
            smaller=np.asarray(out_sml)[:h],
            char=np.asarray(out_chr)[:h].astype(np.uint8))
        head_parts.append(part)
        if ref_sa is None:
            ref_sa = np.asarray(rsa)[:n]
            ref_isa = np.asarray(risa)[:n]
        prev_pos0 = last_pos
        if ckpt:
            ckpt.save_block(b0, part, rho, last_pos,
                            ref_sa if b0 == 0 else None,
                            ref_isa if b0 == 0 else None)
        prev_b0 = int(sx[b0 + emit_len - 1])
        b0 += emit_len
        progress.update(emit_len)

    ref_bwt = np.where(ref_sa > 0, x_aug[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    cat = lambda k: (np.concatenate([p[k] for p in head_parts])
                     if head_parts else np.zeros(0, np.int64))
    head_t = cat("t")
    return DenseHeadsResult(
        head_t=head_t, head_pos=cat("pos"), head_len=cat("length"),
        head_smaller=np.concatenate([p["smaller"] for p in head_parts]),
        head_char=np.concatenate([p["char"] for p in head_parts]),
        ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=len(head_t), sn=sn, irreducible=total_rho)


# ---------------------------------------------------------------------------
# Device-resident blocked execution (HBM-bound workloads, device merge)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def _concat_block_heads(ts, poss, lens, smls, chrs, hs, b0s, h_pad: int):
    """Concatenate per-block compacted head records ON DEVICE into one
    stream-ordered array set: per-block local t becomes global t + b0,
    pads key to INT_MAX, one sort orders and compacts. Blocks are
    stream-ordered already, so the sort only interleaves pad tails."""
    gt = []
    for t, hb, b0 in zip(ts, hs, b0s):
        i = jnp.arange(t.shape[0], dtype=jnp.int32)
        gt.append(jnp.where(i < hb, t + b0, INT_MAX))
    key = jnp.concatenate(gt)
    pos = jnp.concatenate(poss)
    ln = jnp.concatenate(lens)
    sml = jnp.concatenate([s.astype(jnp.int32) for s in smls])
    ch = jnp.concatenate([c.astype(jnp.int32) for c in chrs])
    k_s, p_s, l_s, s_s, c_s = jax.lax.sort(
        (key, pos, ln, sml, ch), num_keys=1)
    L = key.shape[0]
    if L < h_pad:
        padw = h_pad - L
        k_s = jnp.concatenate([k_s, jnp.full(padw, INT_MAX, jnp.int32)])
        p_s = jnp.concatenate([p_s, jnp.zeros(padw, p_s.dtype)])
        l_s = jnp.concatenate([l_s, jnp.zeros(padw, l_s.dtype)])
        s_s = jnp.concatenate([s_s, jnp.zeros(padw, s_s.dtype)])
        c_s = jnp.concatenate([c_s, jnp.zeros(padw, c_s.dtype)])
    sl = lambda a: jax.lax.dynamic_slice(a, (0,), (h_pad,))
    return sl(k_s), sl(p_s), sl(l_s), sl(s_s), sl(c_s)


def ms_dense_heads_blocked_on_device(x_aug: np.ndarray, sx: np.ndarray,
                                     block_chars: int,
                                     ctx_chars: int | None = None,
                                     merge_hook=None) -> DeviceHeadsResult:
    """Blocked dense MS whose per-block head records STAY on device: the
    device-resident generalization of ms_dense_heads_blocked for
    HBM-bound workloads feeding the device merge. Per block only the
    (h, viol, last_pos) scalar triple and the rho stats reach the host;
    head records, the reference order, and the final merge inputs never
    cross the host link (a host round trip would ship ~50 MB of heads +
    40 MB of ref arrays down and back up at the 100 Mchar ecoli
    config).

    Blocks run serially (prev_pos0 chaining keeps cross-block head flags
    exact, ref CMS-BWT-functions.cpp:360), with packed uploads and the
    wide seed when the collection is ACGT-pure."""
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    enable_compilation_cache()
    mark = _stage_timer()
    n = len(x_aug)
    sn = len(sx)
    if ctx_chars is None:
        ctx_chars = max(1 << 16, block_chars // 8)
    sep_cum = _SepCounter(sx)
    n_pad = bucket_size(n)
    x_u8 = np.zeros(n_pad, np.uint8)
    x_u8[:n] = x_aug
    px = _pack2_host(x_u8, n)
    progress = _block_progress(sn)
    bs_pad0 = bucket_size(block_chars + ctx_chars)
    wave = _scan_prewarm(n_pad, bs_pad0, n_pad + bs_pad0,
                         wide=px is not None)
    from ..utils import prewarm as _prewarm
    if _prewarm.enabled():
        _S, _i32 = _prewarm.sds, jnp.int32
        wave.add("post_block", _postprocess_block,
                 _S((n_pad + bs_pad0,), jnp.uint8), _S((bs_pad0,), _i32),
                 _S((bs_pad0,), _i32), _S((bs_pad0,), jnp.bool_),
                 _S((), _i32), _S((), _i32), _S((), _i32), _S((), _i32),
                 n_pad=n_pad, sn_pad=bs_pad0)

    parts: list = []
    ref_sa = ref_isa = b_keep = None
    prev_pos0 = -2
    prev_b0v = None
    total_rho = 0
    x_packed_dev = x_raw_dev = None
    b0 = 0
    while b0 < sn:
        emit_len = min(block_chars, sn - b0)
        ctx = ctx_chars
        while True:
            end = min(b0 + emit_len + ctx, sn)
            sx_blk = sx[b0:end]
            bs_pad = bucket_size(block_chars + ctx)
            if bs_pad == len(sx_blk) and sx_blk[-1] != SEPARATOR:
                bs_pad = bucket_size(bs_pad + 1)
            m = n_pad + bs_pad
            sx_u8 = np.zeros(bs_pad, np.uint8)
            sx_u8[: len(sx_blk)] = sx_blk
            sep_base = sep_cum.before(b0)
            psx = _pack2_host(sx_u8, len(sx_blk)) if px is not None else None
            wide = False
            mark("    blk_hostpack")
            wave.ready("build")
            if psx is not None:
                exc_pos = np.concatenate([px[1], psx[1] + np.int32(n_pad)])
                exc_val = np.concatenate([px[2], psx[2]])
                chk = np.concatenate([px[2], psx[2][psx[2] != SEPARATOR]])
                wide = (m < (1 << 26)
                        and len(chk) == len(np.unique(chk)))
                e_pad = _pow2_pad(len(exc_pos) + 1)
                ep = np.full(e_pad, m, np.int32)
                ep[:len(exc_pos)] = exc_pos
                ev = np.zeros(e_pad, np.uint8)
                ev[:len(exc_val)] = exc_val
                if x_packed_dev is None:
                    x_packed_dev = _put(px[0])
                up = _put(psx[0])
                mark("    blk_put", up)
                b, sp = _build_joint_device_packed(
                    x_packed_dev, up, _put(ep), _put(ev),
                    _put_i32(n), _put_i32(len(sx_blk)),
                    _put_i32(sep_base), n_pad, bs_pad, e_pad)
            else:
                if x_raw_dev is None:
                    x_raw_dev = _put(x_u8)
                b, sp = _build_joint_device(
                    x_raw_dev, _put(sx_u8), _put_i32(n),
                    _put_i32(len(sx_blk)), _put_i32(sep_base),
                    n_pad, bs_pad)
            mark("  blk_build", b)
            wave.ready("jsa")
            sa, isa, hist, packs, k_star, split_lv = _joint_sa(
                b, sp, m, wide)
            mark("  blk_jsa", sa)
            wave.ready("irr")
            stats_dev, ai_all, bi_all, lv_all = _irreducible_slots(
                b, sp, sa, isa, split_lv, _put_i32(n),
                _put_i32(len(sx_blk)), m, n_pad)
            stats = _get(stats_dev)
            rho = int(stats[0])
            rho_pad = min(_pow2_pad(rho), m)
            mark("  blk_irr(rho=%d)" % rho)
            ell = _lift_orchestrated(hist, packs, ai_all, bi_all, lv_all,
                                     isa, stats, m, rho_pad)
            mark("  blk_lift", ell)
            n_t = _put_i32(n)
            wave.ready("nbr")
            pred_pos, succ_pos, av, bv = _neighbors(sa, ell, n_t, m)
            wave.ready("asm")
            pos, length, smaller, rsa, risa = _assemble(
                sa, pred_pos, succ_pos, av, bv, n_t,
                _put_i32(len(sx_blk)), m, n_pad, bs_pad)
            mark("  blk_nbr_asm", pos)
            pb0 = _put_i32(SEPARATOR if prev_b0v is None else prev_b0v)
            wave.ready("post_block")
            (pos, length, smaller, is_head, char,
             scalars) = _postprocess_block(
                b, pos, length, smaller, n_t, _put_i32(emit_len),
                _put_i32(prev_pos0), pb0, n_pad, bs_pad)
            h_b, viol, last_pos = (int(v) for v in _get(scalars))
            mark("  blk_post")
            if viol and end < sn:
                import sys as _sys
                print(f"#   block@{b0}: context overflow, retry "
                      f"ctx {ctx} -> {ctx * 2}", file=_sys.stderr)
                ctx *= 2
                continue
            break
        total_rho += rho
        ch_pad = min(_pow2_pad(h_b + 1), bs_pad)
        out = _compact_heads_raw(pos, length, smaller, is_head, char,
                                 bs_pad, ch_pad)
        parts.append((out, h_b, b0))
        if ref_sa is None:
            ref_sa, ref_isa, b_keep = rsa, risa, b
        prev_pos0 = last_pos
        prev_b0v = int(sx[b0 + emit_len - 1])
        b0 += emit_len
        progress.update(emit_len)
        mark("block@%d(h=%d)" % (b0, h_b), out[0])

    h = sum(p[1] for p in parts)
    h_pad = bucket_size(h + 1)
    if merge_hook is not None:
        merge_hook(h_pad, n_pad)
    ts = tuple(p[0][0] for p in parts)
    poss = tuple(p[0][1] for p in parts)
    lens = tuple(p[0][2] for p in parts)
    smls = tuple(p[0][3] for p in parts)
    chrs = tuple(p[0][4] for p in parts)
    hs = tuple(_put_i32(p[1]) for p in parts)
    b0s = tuple(_put_i32(p[2]) for p in parts)
    t_c, pos_c, len_c, sml_c, chr_c = _concat_block_heads(
        ts, poss, lens, smls, chrs, hs, b0s, h_pad)
    mark("concat_blocks(h=%d)" % h, t_c)
    (t, pos_h, len_h, sml_h, chr_h, ref_sa, ref_isa,
     ref_bwt) = _finish_for_merge(
        t_c, pos_c, len_c, sml_c != 0, chr_c,
        ref_sa, ref_isa, b_keep, _put_i32(n),
        _put_i32(h), h_pad, n_pad)
    mark("finish_for_merge", t)
    return DeviceHeadsResult(
        head_t=t, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=total_rho)
