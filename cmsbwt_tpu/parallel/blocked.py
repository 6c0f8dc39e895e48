"""Multi-device blocked dense execution: collection blocks fan out
round-robin over local devices (the index replicated per device), results
merge on host. This is the production scale-out path (SURVEY.md §7.7): block
independence comes from the endpoint-property argument in ops/ms_dense.py,
so no collectives are needed during the scan — only the O(n + H) reductions
at the end (count sums + head concatenation), the distributed analogue of
the reference's chunked ``.phrases`` merge (ref CMS-BWT-functions.cpp:
1394-1416).

Cross-block head flags: blocks run with an unknown predecessor, so every
block-first position is provisionally a head; the host fixup reclassifies it
as a tail when the previous block's final pos chains into it (the
``pos != prevPos + 1`` rule, ref :360).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SEPARATOR
from ..ops import ms_dense as MD


def ms_dense_heads_parallel(x_aug: np.ndarray, sx: np.ndarray,
                            block_chars: int, ctx_chars: int | None = None,
                            devices=None,
                            blocks_in_flight: int | None = None,
                            checkpoint_dir: str | None = None,
                            fingerprint: str | None = None
                            ) -> MD.DenseHeadsResult:
    from ..utils.jaxcache import bucket_size, enable_compilation_cache
    enable_compilation_cache()
    if devices is None:
        devices = jax.local_devices()
    n = len(x_aug)
    sn = len(sx)
    if ctx_chars is None:
        ctx_chars = max(1 << 16, block_chars // 8)
    s_total = int((sx == SEPARATOR).sum())
    sep_cum = np.cumsum(sx == SEPARATOR)
    n_pad = bucket_size(n)

    # block table
    starts = list(range(0, sn, block_chars))
    blocks = [dict(b0=b0, emit=min(block_chars, sn - b0), ctx=ctx_chars)
              for b0 in starts]

    x_u8_pad = np.zeros(n_pad, np.uint8)
    x_u8_pad[:n] = x_aug
    # upload the padded reference once per device
    x_dev_cache = {}

    def ref_on(dev):
        if dev not in x_dev_cache:
            x_dev_cache[dev] = jax.device_put(jnp.asarray(x_u8_pad), dev)
        return x_dev_cache[dev]

    def _sx_block(blk):
        b0, emit, ctx = blk["b0"], blk["emit"], blk["ctx"]
        end = min(b0 + emit + ctx, sn)
        sx_blk = sx[b0:end]
        # fixed bucket for every block so shapes are shared
        bs_pad = bucket_size(block_chars + ctx)
        if bs_pad == len(sx_blk) and sx_blk[-1] != SEPARATOR:
            bs_pad = bucket_size(bs_pad + 1)  # joint must end special
        sx_u8 = np.zeros(bs_pad, np.uint8)
        sx_u8[: len(sx_blk)] = sx_blk
        return sx_u8, bs_pad, len(sx_blk)

    # upload prefetch: device_put is async, so the NEXT wave's collection
    # blocks ride the host link while the current wave computes
    uploads: dict = {}

    def upload_sx(bi, dev):
        blk = blocks[bi]
        key = (bi, blk["ctx"], getattr(dev, "id", repr(dev)))
        if key not in uploads:
            sx_u8, bs_pad, len_blk = _sx_block(blk)
            uploads[key] = (jax.device_put(jnp.asarray(sx_u8), dev),
                            bs_pad, len_blk)
        return uploads[key]

    def prefetch(wave_next):
        for i, bi in enumerate(wave_next):
            upload_sx(bi, devices[i % len(devices)])

    def build_j(blk, bi, dev):
        sx_dev, bs_pad, len_blk = upload_sx(bi, dev)
        uploads.pop((bi, blk["ctx"], getattr(dev, "id", repr(dev))), None)
        sep_base = int(sep_cum[blk["b0"] - 1]) if blk["b0"] > 0 else 0
        blk["bs_pad"] = bs_pad
        blk["m"] = n_pad + bs_pad
        blk["len_blk"] = len_blk
        return MD._build_joint_device(
            ref_on(dev), sx_dev,
            jnp.int32(n), jnp.int32(len_blk),
            jnp.int32(sep_base), n_pad, bs_pad)

    if blocks_in_flight is None:
        # two blocks per device keeps the queue busy between host syncs;
        # each in-flight block holds its rank history (~levels*m_b int32)
        blocks_in_flight = 2 * len(devices)
    ckpt = MD._block_ckpt(checkpoint_dir, fingerprint, block_chars)
    progress = MD._block_progress(sn)
    pending = list(range(len(blocks)))
    results = [None] * len(blocks)
    ref_sa_holder = [None, None]
    if ckpt:
        still = []
        for bi in pending:
            cached = ckpt.load_block(blocks[bi]["b0"])
            if cached is None:
                still.append(bi)
                continue
            part = cached["part"]
            results[bi] = dict(rho=cached["rho"], h=len(part["t"]),
                               last_pos=cached["last_pos"], **part)
            if ref_sa_holder[0] is None and cached.get("ref_sa") is not None:
                ref_sa_holder[0] = cached["ref_sa"]
                ref_sa_holder[1] = cached["ref_isa"]
            progress.update(blocks[bi]["emit"])
        pending = still
    while pending:
        wave, pending = (pending[:blocks_in_flight],
                         pending[blocks_in_flight:])
        # pass 1: joint SA + irreducible count per block, async round-robin
        stage = []
        for i, bi in enumerate(wave):
            blk = blocks[bi]
            dev = devices[i % len(devices)]
            b, sp = build_j(blk, bi, dev)
            sa, isa, hist, pack8, k_star, split_lv = MD._joint_sa(
                b, sp, blk["m"])
            stats_dev, ai_all, bi_all, lv_all = MD._irreducible_slots(
                b, sp, sa, isa, split_lv, jnp.int32(n),
                jnp.int32(blk["len_blk"]), blk["m"], n_pad)
            stage.append((bi, b, sa, isa, hist, pack8, stats_dev,
                          ai_all, bi_all, lv_all))
        # overlap: enqueue the next wave's uploads behind pass 1's compute
        prefetch(pending[:blocks_in_flight])
        # pass 2: lift -> neighbors -> assemble -> postprocess
        out = []
        for (bi, bjoint, sa, isa, hist, pack8, stats_dev, ai_all,
             bi_all, lv_all) in stage:
            blk = blocks[bi]
            m = blk["m"]
            stats = np.asarray(stats_dev)
            rho = int(stats[0])
            rho_pad = min(MD._pow2_pad(rho), m)
            ell = MD._lift_orchestrated(hist, pack8, ai_all, bi_all,
                                        lv_all, isa, stats, m, rho_pad)
            n_t = jnp.int32(n)
            pred_pos, succ_pos, a, b = MD._neighbors(sa, ell, n_t, m)
            pos, length, smaller, rsa, risa = MD._assemble(
                sa, pred_pos, succ_pos, a, b, n_t,
                jnp.int32(blk["len_blk"]), m, n_pad,
                blk["bs_pad"])
            pb0 = (jnp.int32(SEPARATOR) if blk["b0"] == 0
                   else jnp.int32(int(sx[blk["b0"] - 1])))
            (pos, length, smaller, is_head, char,
             scalars) = MD._postprocess_block(
                bjoint, pos, length, smaller, n_t, jnp.int32(blk["emit"]),
                jnp.int32(-2), pb0, n_pad,
                blk["bs_pad"])
            out.append((bi, rho, pos, length, smaller, is_head,
                        char, scalars, rsa, risa))
        # pass 3: check violations, compact, download (failed blocks are
        # re-queued with doubled context)
        new_pending = []
        for (bi, rho, pos, length, smaller, is_head, char,
             scalars, rsa, risa) in out:
            blk = blocks[bi]
            end = min(blk["b0"] + blk["emit"] + blk["ctx"], sn)
            h, viol, last_pos = (int(v) for v in np.asarray(scalars))
            if viol and end < sn:
                for k in [k for k in uploads if k[0] == bi]:
                    uploads.pop(k, None)  # stale prefetches
                blk["ctx"] *= 2
                new_pending.append(bi)
                continue
            h_pad = min(MD._pow2_pad(h), blk["bs_pad"])
            out_t, out_pos, out_len, out_sml, out_chr = MD._compact_heads(
                pos, length, smaller, is_head, char,
                blk["bs_pad"], h_pad)
            results[bi] = dict(
                rho=rho, h=h,
                t=np.asarray(out_t)[:h].astype(np.int64) + blk["b0"],
                pos=np.asarray(out_pos)[:h].astype(np.int64),
                length=np.asarray(out_len)[:h].astype(np.int64),
                smaller=np.asarray(out_sml)[:h].copy(),
                char=np.asarray(out_chr)[:h].astype(np.uint8),
                last_pos=last_pos)
            # the reference part of the joint order is identical in every
            # block: download it once
            if ref_sa_holder[0] is None:
                ref_sa_holder[0] = np.asarray(rsa)[:n]
                ref_sa_holder[1] = np.asarray(risa)[:n]
            if ckpt:
                first = blocks[bi]["b0"] == 0
                ckpt.save_block(
                    blocks[bi]["b0"],
                    {k: results[bi][k]
                     for k in ("t", "pos", "length", "smaller", "char")},
                    rho, last_pos,
                    ref_sa_holder[0] if first else None,
                    ref_sa_holder[1] if first else None)
            progress.update(blocks[bi]["emit"])
        pending = new_pending + pending

    # host fixup: block-first positions that chain from the previous block's
    # last pos are tails, not heads
    for bi in range(1, len(blocks)):
        r = results[bi]
        prev_last = results[bi - 1]["last_pos"]
        if r["h"] and r["t"][0] == blocks[bi]["b0"] and \
                r["pos"][0] == prev_last + 1:
            for k in ("t", "pos", "length", "smaller", "char"):
                r[k] = r[k][1:]
            r["h"] -= 1

    ref_sa = ref_sa_holder[0]
    ref_isa = ref_sa_holder[1]
    ref_bwt = np.where(ref_sa > 0, x_aug[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    cat = lambda k, d: (np.concatenate([r[k] for r in results])
                        if results else np.zeros(0, d))
    head_t = cat("t", np.int64)
    return MD.DenseHeadsResult(
        head_t=head_t, head_pos=cat("pos", np.int64),
        head_len=cat("length", np.int64),
        head_smaller=cat("smaller", bool),
        head_char=cat("char", np.uint8),
        ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=len(head_t), sn=sn,
        irreducible=int(sum(r["rho"] for r in results)))

