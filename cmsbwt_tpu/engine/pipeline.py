"""End-to-end pipeline: the ``computeBWT`` equivalent
(ref ``CMS-BWT-functions.cpp:1788-1797``).

Unlike the reference's small/large split (dense vector-of-maps vs
unordered_map + disk spill), the array-parallel engine uses one code path;
the small/large distinction survives only as the memory-policy knob for
sharding/streaming (see ``cmsbwt_tpu/parallel``) and the small path's debug
artifact (``<out>.counterSmallerThanHead_true``, ref :919-924) emitted for
artifact parity.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..io import fasta
from ..index.host import ReferenceIndex, build_reference_index
from ..utils.timing import PhaseTimer, maybe_jax_trace
from . import heads as heads_mod
from . import merge as merge_mod
from . import ranking as ranking_mod
from . import tails as tails_mod
from .ms_host import MSArrays, ms_scan_collection


@dataclass
class PipelineResult:
    run_len: np.ndarray
    run_char: np.ndarray
    d: int
    sn: int
    h: int
    counter: np.ndarray | None = None  # counterSmallerThanHead (debug artifact)


def compute_bwt_arrays(index: ReferenceIndex, coll: fasta.Collection,
                       rle_quirk: bool,
                       ms: MSArrays | None = None,
                       timer: PhaseTimer | None = None,
                       buffer_bytes: int | None = None) -> PipelineResult:
    """Run the full CMS pipeline on in-memory arrays.

    ``ms`` may be precomputed (e.g. by the device kernel); otherwise the
    host scan is used.
    """
    timer = timer or PhaseTimer()
    d = coll.d
    if ms is None:
        with timer.phase("ms_scan"):
            ms = ms_scan_collection(index, coll.sx, coll.sep_positions)
    with timer.phase("head_extract"):
        heads = heads_mod.extract_heads(index, ms, coll.sx)
    return merge_from_heads(index, heads, d, coll.sn, rle_quirk, timer,
                            buffer_bytes=buffer_bytes)


def merge_from_heads(index: ReferenceIndex, heads, d: int, sn: int,
                     rle_quirk: bool,
                     timer: PhaseTimer | None = None,
                     buffer_bytes: int | None = None) -> PipelineResult:
    """Downstream engine: head fixup -> grouping -> ranking -> tail
    positioning -> run assembly. Input-agnostic (host scan, device lane
    kernel, or dense joint-sort all produce the same head records).

    Tail bucket counts are derived from the head records: head h owns tails
    at reference positions pos_h+1 .. pos_h+to_next_h (consecutive by the
    MS sliding property), so a difference array over those spans equals the
    reference's bucketsForExpandedBWT tail tally (ref :368-377)."""
    timer = timer or PhaseTimer()
    with timer.phase("head_fixup"):
        heads_mod.fixup_heads(index, heads)
    with timer.phase("bucket_counts"):
        # bincount, not np.add.at: ~3.5x faster at tens of millions of heads
        hn = heads.to_next > 0
        hp = heads.pos[hn] + 1
        diff = np.bincount(hp, minlength=index.n + 1)[:index.n + 1]
        diff = diff.astype(np.int64)
        diff -= np.bincount(hp + heads.to_next[hn],
                            minlength=index.n + 1)[:index.n + 1]
        tails_cnt = np.cumsum(diff[:-1])
    with timer.phase("head_group"):
        classes = heads_mod.build_classes(index, heads)
    with timer.phase("head_rank"):
        ranked = ranking_mod.rank_heads(index, classes, heads, d)
    with timer.phase("tail_position"):
        counter = tails_mod.position_tails(index, classes, ranked,
                                           buffer_bytes=buffer_bytes)
    with timer.phase("merge"):
        run_len, run_char = merge_mod.build_runs(
            index, classes, ranked, counter, tails_cnt, d, rle_quirk)
    return PipelineResult(run_len=run_len, run_char=run_char, d=d,
                          sn=sn, h=heads.h, counter=counter)


def compute_bwt(cfg: Config) -> dict:
    """Full file-to-file run (ref main.cpp:85-132 + computeBWT)."""
    timer = PhaseTimer()
    ref_path, coll_path = fasta.read_input_list(cfg.filename)
    outname = cfg.resolved_outname()

    with timer.phase("load_reference"):
        ref = fasta.load_reference_bytes(ref_path)
        x_aug = fasta.augment_reference(ref)
    # references at/above the int32 bound (the reference binary's own hard
    # cap: int32 libsais SA, ref CMS-BWT-functions.cpp:246, CMS-BWT.h:44)
    # route through the sharded int64 index (parallel/sharded_index.py,
    # docs/giant_references.md item 4). The threshold is overridable so the
    # int64 route is CI-testable at toy scale.
    giant = len(x_aug) >= _giant_threshold()
    if giant and cfg.backend not in ("auto", "host"):
        raise ValueError(
            f"reference is {len(x_aug)} chars (>= the int32 index bound): "
            f"backend={cfg.backend} uses int32 device paths (the reference "
            "tool's own cap). Giant references route backend=auto/host "
            "through the sharded int64 index (docs/giant_references.md).")
    sn_limit = fasta.collection_sn_limit(coll_path, cfg.prefix_length)
    coll_chars = min(os.path.getsize(coll_path), cfg.prefix_length)
    # parse BEFORE backend resolution: the auto-dispatch divergence probe
    # (engine/probe.py) samples parsed collection k-mers
    with timer.phase("parse_collection"):
        coll = fasta.parse_collection(coll_path, sn_limit)
        fasta.validate_collection(coll)
    if giant:
        # giant references: the sharded int64 mesh index feeds the native
        # int64 scan engine (cms_ms_scan_i64) — the production engine
        # behind the >2^31 route; the numpy spec scan remains only as the
        # no-toolchain fallback inside the native branch
        from ..io.native import get_scan_lib
        backend = "native" if (get_scan_lib() is not None
                               and cfg.backend != "host") else "host"
    else:
        backend = _resolve_backend(cfg.backend, coll_chars, x_aug=x_aug,
                                   sx=coll.sx, cfg=cfg,
                                   ref_path=ref_path, coll_path=coll_path)
    dindex = None
    index = None
    with timer.phase("build_index"):
        # reference-index cache (SURVEY §5 failure-recovery row + bwa-style
        # one-time indexing): the index depends only on the reference file,
        # so it is cached on disk by default (cfg.index_cache_dir; the
        # explicit checkpoint_dir takes precedence) and reused across runs
        # and crash restarts. The dense path has its own dense_heads
        # checkpoint; the device backend keeps arrays on-chip.
        idx_ckpt = idx_fp = None
        cache_root = cfg.checkpoint_dir or cfg.resolved_index_cache_dir()
        host_index_wanted = giant or backend not in (
            "dense", "jump", "device")
        if cache_root and host_index_wanted:
            from ..utils.checkpoint import CheckpointManager, file_stamp
            idx_ckpt = CheckpointManager(cache_root)
            idx_fp = idx_ckpt.fingerprint(ref=file_stamp(ref_path),
                                          giant=giant, phase="ref_index")
            cached_idx = idx_ckpt.load("ref_index", idx_fp)
            if cached_idx is not None:
                index = _index_from_arrays(x_aug, cached_idx)
        if index is None and giant:
            from ..parallel.sharded_index import (
                build_sharded_reference_index)
            index = build_sharded_reference_index(x_aug)
        elif index is None and backend == "device":
            from ..index.device import build_device_index
            dindex = build_device_index(x_aug)
            index = _export_device_index(dindex, x_aug)
        elif index is None and backend == "native":
            index = _build_host_index_fast(x_aug)
        elif index is None and backend not in ("dense", "jump"):
            index = build_reference_index(x_aug)
        if idx_ckpt is not None and index is not None and cached_idx is None:
            idx_ckpt.save("ref_index", idx_fp, {
                "sa": index.sa, "isa": index.isa, "lcp": index.lcp,
                "plcp": index.plcp, "bwt": index.bwt})

    if coll.sn == 0:
        # empty collection -> empty BWT (the reference emits nothing)
        if index is None:
            index = build_reference_index(x_aug)
        result = PipelineResult(run_len=np.zeros(0, np.int64),
                                run_char=np.zeros(0, np.uint8),
                                d=coll.d, sn=0, h=0)
        return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)

    # collections at/above the int32 bound (the reference's sn is uint64 —
    # unbounded, ref CMS-BWT.h:26,46): the unblocked device scans and the
    # device merge are int32-keyed, so such runs must take the int64-safe
    # route — blocked dense scan (global head_t is int64 on the host,
    # ms_dense.py:836) + host merge. The bound is overridable
    # (CMSBWT_SN_BOUND) so CI proves the route byte-equal at toy scale.
    sn_big = coll.sn >= _sn_bound()
    if sn_big:
        if cfg.merge_backend == "device":
            raise ValueError(
                f"collection has {coll.sn} chars (>= the int32 device-merge "
                f"bound {_sn_bound()}): merge_backend='device' cannot run "
                "it; use merge_backend=auto/host")
        if cfg.backend in ("jump", "device"):
            raise ValueError(
                f"collection has {coll.sn} chars (>= the int32 bound "
                f"{_sn_bound()}): backend={cfg.backend} uses int32 device "
                "scans; use backend=auto/dense (blocked) or host")
        if backend in ("jump", "device", "dense"):
            backend = "dense"   # blocked int64 route, forced below

    ms = None
    if backend == "native":
        # native OpenMP PLCP-skip scan (native/cmsbwt_scan.cpp): the
        # low-divergence fast path — per-phrase sequential work streams at
        # C++ speed, documents scan in parallel threads, and the int64-
        # safe host merge finishes (so sn >= 2^31 collections are fine)
        rq = cfg.rle and cfg.replicate_reference_rle_quirk
        from ..io import native as native_io
        heads = None
        with timer.phase("ms_scan"):
            res = native_io.ms_scan_native(
                index.x_padded, index.sa, index.isa, index.lcp,
                index.plcp, index.n, coll.sx, coll.sep_positions)
            if res is not None:
                t, pos, ln, sml = res
                z = lambda: np.zeros(len(t), np.int64)
                char = coll.sx[(t - 1) % max(coll.sn, 1)]
                heads = heads_mod.HeadArrays(
                    t=t, pos=pos, length=ln, smaller=sml, char=char,
                    to_next=z(), isa_next=z(), succ=z(), h=len(t))
            else:
                # no toolchain: the host spec scan computes the same heads
                ms_arrays = ms_scan_collection(index, coll.sx,
                                               coll.sep_positions)
                heads = heads_mod.extract_heads(index, ms_arrays, coll.sx)
        result = merge_from_heads(index, heads, coll.d, coll.sn,
                                  rle_quirk=rq, timer=timer,
                                  buffer_bytes=cfg.buffer_gib << 30)
        return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)
    if backend == "jump":
        # head-jumping scan (ops/ms_jump): per-PHRASE device work — the
        # low-divergence fast path. Scan result and reference index stay
        # on device; the device merge finishes the pipeline.
        from .device_merge import merge_heads_device_resident
        rq = cfg.rle and cfg.replicate_reference_rle_quirk
        lanes = cfg.lanes
        if cfg.backend == "auto" and not _on_accelerator():
            # auto-resolved CPU jump: the accelerator lane default
            # over-subscribes the element-bound CPU backend (see
            # AUTO_CPU_JUMP_LANES)
            lanes = min(lanes, AUTO_CPU_JUMP_LANES)
        with timer.phase("ms_scan"), maybe_jax_trace("ms_scan"):
            from ..ops.ms_jump import ms_jump_heads
            jres = ms_jump_heads(x_aug, coll.sx, lanes=lanes,
                                 window=cfg.skip_window)
        # merge routing: explicit cfg wins, then the CMSBWT_MERGE_BACKEND
        # env override, then auto = host only for the accelerator SARS
        # shape (the scan result is device-resident here, so auto's
        # default stays on-chip even on CPU-only processes)
        _env_mb = os.environ.get("CMSBWT_MERGE_BACKEND")
        if cfg.merge_backend != "auto":
            route_host = cfg.merge_backend == "host"
        elif _env_mb in ("host", "device"):
            route_host = _env_mb == "host"
        else:
            route_host = _on_accelerator() and _resolve_merge_backend(
                "auto", n=len(x_aug), sn=coll.sn) == "host"
        if cfg.merge_backend == "sharded":
            dl = download_heads_result(jres, len(x_aug))
            result = merge_from_heads_sharded(x_aug, dl, coll.d, coll.sn,
                                              rq, timer)
            index = ReferenceIndex(
                x=x_aug,
                x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
                n=len(x_aug), sa=None, isa=None, lcp=None, plcp=None,
                bwt=None, rank_history=[])
            return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)
        if route_host:
            # SARS-like shape: download the compacted heads and finish on
            # the native OpenMP engine (see _resolve_merge_backend)
            index, heads = dense_result_to_inputs(
                x_aug, download_heads_result(jres, len(x_aug)))
            result = merge_from_heads(index, heads, coll.d, coll.sn,
                                      rle_quirk=rq, timer=timer,
                                      buffer_bytes=cfg.buffer_gib << 30)
            return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)
        with timer.phase("merge_device"):
            run_len, run_char, counter = merge_heads_device_resident(
                jres, coll.d, rq,
                want_counter=len(x_aug) < cfg.small_ref_threshold)
        index = ReferenceIndex(
            x=x_aug,
            x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
            n=len(x_aug), sa=None, isa=None, lcp=None, plcp=None,
            bwt=None, rank_history=[])
        result = PipelineResult(
            run_len=run_len, run_char=run_char, d=coll.d, sn=coll.sn,
            h=jres.h, counter=counter)
        return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)
    if backend == "device" and coll.sn > 0:
        from ..ops.ms_device import ms_scan_device
        with timer.phase("ms_scan"):
            dev = ms_scan_device(dindex, coll.sx, lanes=cfg.lanes,
                                 window=cfg.skip_window)
        ms = MSArrays(pos=dev.pos, length=dev.length, smaller=dev.smaller,
                      is_head=dev.is_head)
    elif backend == "dense":
        # joint suffix sort computes MS, head records, and the ref index in
        # one device pipeline; only O(n + H) data reaches the host
        from ..ops.ms_dense import DenseHeadsResult, ms_dense_heads
        from ..utils.checkpoint import CheckpointManager, file_stamp
        ckpt = CheckpointManager(cfg.checkpoint_dir)
        fp = ckpt.fingerprint(ref=file_stamp(ref_path),
                              coll=file_stamp(coll_path),
                              prefix=cfg.prefix_length, phase="dense_heads")
        cached = ckpt.load("dense_heads", fp) if cfg.checkpoint_dir else None
        # --parallel without --block-chars: derive a per-device block size
        # (ceil(sn / n_devices), capped by the reference's phrase-chunk cap)
        block_chars = cfg.dense_block_chars
        if cfg.dense_parallel and not block_chars:
            import jax
            ndev = max(1, len(jax.local_devices()))
            block_chars = max(min(-(-coll.sn // ndev),
                                  cfg.chunk_cap_bytes // 8), 1 << 16)
        if block_chars is None:
            block_chars = _guard_block_chars(len(x_aug), coll.sn,
                                             _device_memory_budget())
        if sn_big:
            # int64-safe route: per-block scans stay under the int32 bound
            # while global head_t is assembled int64 on the host
            cap = max(min(cfg.chunk_cap_bytes // 8, _sn_bound() // 2),
                      1 << 12)
            block_chars = min(block_chars, cap) if block_chars else cap
        # device-resident fast path: scan result stays on the chip and feeds
        # the device merge directly — nothing O(n + H) crosses the host link.
        # Covers the unblocked scan AND the single-device blocked scan
        # (ms_dense_heads_blocked_on_device); checkpointing, sn_big, and
        # the multi-device parallel mode still need host arrays
        dr_mb = _resolve_merge_backend(cfg.merge_backend)
        device_resident = (
            dr_mb in ("device", "sharded")
            and not cfg.checkpoint_dir and not sn_big
            and not (block_chars and cfg.dense_parallel))
        if device_resident:
            from ..ops.ms_dense import (ms_dense_heads_blocked_on_device,
                                        ms_dense_heads_on_device)
            rq = cfg.rle and cfg.replicate_reference_rle_quirk
            # fire the merge engine's prewarm wave the moment the scan
            # knows the head count, overlapping those compiles with the
            # scan tail (utils/prewarm)
            mw = {}

            def _merge_hook(h_pad, n_pad):
                from .device_merge import merge_prewarm
                mw["wave"] = merge_prewarm(h_pad, n_pad, rq)

            hook = _merge_hook if dr_mb == "device" else None
            with timer.phase("ms_scan"), maybe_jax_trace("ms_scan"):
                if block_chars:
                    ddres = ms_dense_heads_blocked_on_device(
                        x_aug, coll.sx, block_chars=block_chars,
                        ctx_chars=cfg.dense_ctx_chars,
                        merge_hook=hook)
                else:
                    ddres = ms_dense_heads_on_device(
                        x_aug, coll.sx, merge_hook=hook)
            if dr_mb == "sharded":
                # device-resident arrays feed the mesh merge directly
                # (sharded_merge reshards on-chip via dist.shard_dev)
                from ..parallel.sharded_merge import merge_heads_sharded
                with timer.phase("merge_sharded"):
                    run_len, run_char = merge_heads_sharded(
                        ddres.head_t, ddres.head_pos, ddres.head_len,
                        ddres.head_smaller, ddres.head_char,
                        ddres.ref_sa, ddres.ref_isa, ddres.ref_bwt,
                        ddres.h, len(x_aug), coll.sn, coll.d, rq)
                counter = None
            else:
                with timer.phase("merge_device"):
                    from .device_merge import merge_heads_device_resident
                    run_len, run_char, counter = \
                        merge_heads_device_resident(
                            ddres, coll.d, rq,
                            want_counter=(len(x_aug)
                                          < cfg.small_ref_threshold),
                            wave=mw.get("wave"))
            index = ReferenceIndex(
                x=x_aug, x_padded=np.concatenate(
                    [x_aug, np.zeros(1, np.uint8)]),
                n=len(x_aug), sa=None, isa=None, lcp=None, plcp=None,
                bwt=None, rank_history=[])
            result = PipelineResult(
                run_len=run_len, run_char=run_char, d=coll.d, sn=coll.sn,
                h=ddres.h, counter=counter)
            return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)
        with timer.phase("ms_scan"), maybe_jax_trace("ms_scan"):
            if cached is not None:
                cached = {k: v for k, v in cached.items()}
                dres = DenseHeadsResult(
                    h=int(cached.pop("h")), sn=int(cached.pop("sn")),
                    irreducible=int(cached.pop("irreducible")), **cached)
            elif block_chars and cfg.dense_parallel:
                import jax
                if len(jax.devices()) > 1:
                    # mesh-native: one shard_map program per wave of blocks
                    # (ppermute chain, psum health — parallel/mesh.py)
                    from ..parallel.mesh import ms_dense_heads_mesh
                    dres = ms_dense_heads_mesh(
                        x_aug, coll.sx, block_chars=block_chars,
                        ctx_chars=cfg.dense_ctx_chars)
                else:
                    # single device: bounded in-flight wave pipelining
                    from ..parallel.blocked import ms_dense_heads_parallel
                    dres = ms_dense_heads_parallel(
                        x_aug, coll.sx, block_chars=block_chars,
                        ctx_chars=cfg.dense_ctx_chars,
                        checkpoint_dir=cfg.checkpoint_dir, fingerprint=fp)
            elif block_chars:
                from ..ops.ms_dense import ms_dense_heads_blocked
                dres = ms_dense_heads_blocked(
                    x_aug, coll.sx, block_chars=block_chars,
                    ctx_chars=cfg.dense_ctx_chars,
                    checkpoint_dir=cfg.checkpoint_dir, fingerprint=fp)
            else:
                dres = ms_dense_heads(x_aug, coll.sx)
            if cached is None and cfg.checkpoint_dir:
                ckpt.save("dense_heads", fp, {
                    "head_t": dres.head_t, "head_pos": dres.head_pos,
                    "head_len": dres.head_len,
                    "head_smaller": dres.head_smaller,
                    "head_char": dres.head_char,
                    "ref_sa": dres.ref_sa, "ref_isa": dres.ref_isa,
                    "ref_bwt": dres.ref_bwt,
                    "h": np.int64(dres.h), "sn": np.int64(dres.sn),
                    "irreducible": np.int64(dres.irreducible)})
        index, heads = dense_result_to_inputs(x_aug, dres)
        rq = cfg.rle and cfg.replicate_reference_rle_quirk
        mb = _resolve_merge_backend(cfg.merge_backend)
        if mb == "sharded":
            # mesh sample-sort merge: int64-safe, so sn_big runs it too
            result = merge_from_heads_sharded(x_aug, dres, coll.d, coll.sn,
                                              rq, timer)
        elif not sn_big and mb == "device":
            result = merge_from_heads_device(
                x_aug, dres, coll.d, coll.sn, rq, timer,
                want_counter=len(x_aug) < cfg.small_ref_threshold)
        else:
            result = merge_from_heads(index, heads, coll.d, coll.sn,
                                      rle_quirk=rq, timer=timer,
                                      buffer_bytes=cfg.buffer_gib << 30)
        return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)

    rle_quirk = cfg.rle and cfg.replicate_reference_rle_quirk
    result = compute_bwt_arrays(index, coll, rle_quirk, ms=ms, timer=timer,
                                buffer_bytes=cfg.buffer_gib << 30)
    return _write_outputs(cfg, outname, index, result, timer,
                               backend=backend)


def merge_from_heads_sharded(x_aug: np.ndarray, dres, d: int, sn: int,
                             rle_quirk: bool,
                             timer: PhaseTimer | None = None,
                             n_devices: int | None = None) -> PipelineResult:
    """Downstream merge SHARDED over the device mesh
    (parallel/sharded_merge.py): all five stages run as sample-sort joins
    + routed collectives with int64 keys — no device ever holds the full
    head set, and collections past the int32 device-merge bound are safe.
    The distributed form of the reference's (pos, idx) head sort and
    tail-bucket walk (ref CMS-BWT-functions.cpp:588-593, 1517-1603)."""
    from ..parallel.sharded_merge import merge_heads_sharded
    timer = timer or PhaseTimer()
    with timer.phase("merge_sharded"):
        run_len, run_char = merge_heads_sharded(
            dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
            dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
            dres.h, len(x_aug), sn, d, rle_quirk, n_devices=n_devices)
    return PipelineResult(run_len=run_len, run_char=run_char, d=d, sn=sn,
                          h=dres.h, counter=None)


def merge_from_heads_device(x_aug: np.ndarray, dres, d: int, sn: int,
                            rle_quirk: bool,
                            timer: PhaseTimer | None = None,
                            want_counter: bool = True) -> PipelineResult:
    """Downstream merge on the accelerator (engine/device_merge.py): head
    fixup, grouping, ranking, tail positioning, and run assembly run as
    device sorted joins; only the O(n + H) run list reaches the host."""
    from .device_merge import merge_heads_numpy
    timer = timer or PhaseTimer()
    with timer.phase("merge_device"):
        run_len, run_char, counter = merge_heads_numpy(
            dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
            dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
            dres.h, len(x_aug), sn, d, rle_quirk,
            want_counter=want_counter)
    return PipelineResult(run_len=run_len, run_char=run_char, d=d, sn=sn,
                          h=dres.h, counter=counter)


def download_heads_result(jres, n: int):
    """Device-resident DeviceHeadsResult -> host DenseHeadsResult layout:
    head arrays sliced to h as int64, reference arrays sliced to n (the
    host merge engine expects unpadded arrays)."""
    from dataclasses import replace as _dc_replace
    h = jres.h
    return _dc_replace(
        jres,
        head_t=np.asarray(jres.head_t)[:h].astype(np.int64),
        head_pos=np.asarray(jres.head_pos)[:h].astype(np.int64),
        head_len=np.asarray(jres.head_len)[:h].astype(np.int64),
        head_smaller=np.asarray(jres.head_smaller)[:h],
        head_char=np.asarray(jres.head_char)[:h].astype(np.uint8),
        ref_sa=np.asarray(jres.ref_sa)[:n],
        ref_isa=np.asarray(jres.ref_isa)[:n],
        ref_bwt=np.asarray(jres.ref_bwt)[:n])


def dense_result_to_inputs(x_aug: np.ndarray, dres):
    """(ReferenceIndex, HeadArrays) from a DenseHeadsResult — shared by the
    pipeline and the model API (cmsbwt_tpu/models)."""
    from .heads import HeadArrays
    index = ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=len(x_aug), sa=dres.ref_sa, isa=dres.ref_isa,
        lcp=np.zeros(len(x_aug) + 1, np.int32),
        plcp=np.zeros(len(x_aug), np.int32),
        bwt=dres.ref_bwt, rank_history=[])
    heads = HeadArrays(
        t=dres.head_t, pos=dres.head_pos, length=dres.head_len,
        smaller=dres.head_smaller, char=dres.head_char,
        to_next=np.zeros(dres.h, np.int64),
        isa_next=np.zeros(dres.h, np.int64),
        succ=np.zeros(dres.h, np.int64), h=dres.h)
    return index, heads


def _write_outputs(cfg: Config, outname: str, index: ReferenceIndex,
                   result: PipelineResult, timer: PhaseTimer,
                   backend: str | None = None) -> dict:
    # small-path debug artifact parity (ref :919-924, written unconditionally
    # by the small-reference variant)
    if index.n < cfg.small_ref_threshold and result.counter is not None:
        with open(outname + ".counterSmallerThanHead_true", "wb") as f:
            f.write(result.counter.astype("<u8").tobytes())

    with timer.phase("write_output"):
        from ..io import native
        out_path = outname + (".rl_bwt" if cfg.rle else ".bwt")
        wrote = (native.write_rle_native(out_path, result.run_len,
                                         result.run_char)
                 if cfg.rle else
                 native.write_plain_native(out_path, result.run_len,
                                           result.run_char))
        if wrote:
            nbytes = os.path.getsize(out_path)
        else:  # numpy fallback
            if cfg.rle:
                data = merge_mod.runs_to_rle(result.run_len,
                                             result.run_char)
            else:
                data = merge_mod.runs_to_plain(result.run_len,
                                               result.run_char)
            wb = max(int(cfg.write_buffer_bytes), 1 << 12)
            with open(out_path, "wb") as f:
                for i in range(0, len(data), wb):  # ref's 1 MiB buffer (:943)
                    f.write(data[i:i + wb])
            nbytes = len(data)
    with open(outname + ".log", "w") as f:
        f.write(timer.report())
        f.write(f"\nsn: {result.sn}\nheads: {result.h}\nD: {result.d}\n")
    return {"out_path": out_path, "bytes": nbytes, "timer": timer,
            "result": result, "backend": backend}


# Below this many collection chars, the host scan beats the dense device
# pipeline even with a warm compile cache (dispatch/transfer overheads
# dominate). The value awaits an H100 measurement of the crossover.
AUTO_DENSE_MIN_CHARS = 2_000_000


def _sn_bound() -> int:
    """Collection size at which the int32-keyed device paths stop and the
    blocked-scan + host-merge int64 route takes over (the reference's sn
    is uint64, ref CMS-BWT.h:26,46). Env-overridable for toy-scale CI."""
    from .device_merge import sn_bound
    return sn_bound()


def _giant_threshold() -> int:
    """Reference length at which the int32 index paths stop and the sharded
    int64 route takes over. Defaults to the int32 bound; the env override
    lets CI exercise the giant route at toy scale
    (docs/giant_references.md §validation)."""
    return int(os.environ.get("CMSBWT_GIANT_THRESHOLD", 1 << 31))


def _on_accelerator() -> bool:
    """True when the process's devices are accelerators. A JAX that cannot
    initialise its backend raises here: a device failure must never turn
    into a CPU run."""
    import jax
    return any(dv.platform != "cpu" for dv in jax.devices())


# The dense scan + device merge peak at about this many device bytes per
# bucketed symbol of the joint string (the ~23-level rank history, the
# doubling scan's carry and the multi-operand sort temporaries): measured
# 198.0 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase A:
# 22.0 GB peak over 111 M symbols, 100 Mchars of collection).
BYTES_PER_SYMBOL = 198
# Share of the device's free bytes the guard lets the scan plan for: the
# figure above is one reading at one size, and how the peak scales towards
# the unblocked limit is not measured yet.
GUARD_HEADROOM = 0.85


def _device_memory_budget() -> float | None:
    """Device bytes the dense scan may use: ``CMSBWT_HBM_GB`` when set,
    else GUARD_HEADROOM of the device's ``bytes_limit`` less what the
    process already holds there (``bytes_in_use``); None when the device
    reports no limit (the CPU backend), which forces no blocking."""
    env = os.environ.get("CMSBWT_HBM_GB")
    if env:
        return float(env) * 2**30
    import jax
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
    return GUARD_HEADROOM * float(free)


def _guard_block_chars(n: int, sn: int, budget: float | None) -> int | None:
    """Block size for the dense scan, or None to scan unblocked: above the
    budget the scan streams in blocks, or the run dies with
    RESOURCE_EXHAUSTED."""
    from ..utils.jaxcache import bucket_size
    if budget is None:
        return None
    if BYTES_PER_SYMBOL * (bucket_size(n) + bucket_size(sn + 1)) <= budget:
        return None
    return max(8 << 20,
               int((budget / BYTES_PER_SYMBOL - bucket_size(n)) * 0.6))


def _resolve_merge_backend(merge_backend: str, n: int | None = None,
                           sn: int | None = None) -> str:
    """auto -> device merge on an accelerator, host merge otherwise.

    The device merge keeps the downstream stages (fixup/group/rank/tails/
    runs) on the chip as sorted joins; on CPU-only processes the native
    OpenMP host engine wins (device sorts fall back to CPU XLA there).

    Small-reference / huge-collection workloads (SARS-like pangenomes:
    ~30 Kbp ref, tens of Mchars of documents) also route to the host
    engine on accelerators: tail crediting there is dominated by per-PAIR
    volume (P ~ sn), where the OpenMP walk is expected to beat the device
    sorted join. The shape rule awaits an H100 measurement."""
    if merge_backend != "auto":
        return merge_backend
    forced = os.environ.get("CMSBWT_MERGE_BACKEND")
    if forced in ("host", "device"):
        return forced
    if _on_accelerator():
        if (n is not None and sn is not None
                and n < 1_000_000 and sn > 16 * max(n, 1)):
            return "host"
        return "device"
    return "host"


# CPU XLA is element-bound (no gather-latency floor), so the jump scan's
# lane-count optimum is far below the accelerator default of 4096: a CPU
# sweep at 20 Mchars bottomed at 1024 (24 s; 256->34 s, 8192->102 s).
AUTO_CPU_JUMP_LANES = 1024


def _probe_cached(cfg, x_aug, sx, ref_path, coll_path):
    """kmer_absent_fraction with a tiny disk cache keyed by the input file
    stamps: the probe costs ~50-80 ms at Mbp scale and its answer is a
    pure function of the inputs, so repeat runs skip it entirely."""
    from .probe import kmer_absent_fraction
    mgr = fp = None
    cache_root = cfg.resolved_index_cache_dir()
    if cache_root and ref_path and coll_path:
        try:
            from ..utils.checkpoint import CheckpointManager, file_stamp
            mgr = CheckpointManager(cache_root)
            fp = mgr.fingerprint(ref=file_stamp(ref_path),
                                 coll=file_stamp(coll_path),
                                 prefix=cfg.prefix_length,
                                 k=cfg.probe_kmer, phase="probe")
            cached = mgr.load("probe", fp)
            if cached is not None:
                v = float(cached["frac"])
                return None if v < 0 else v
        except Exception:
            mgr = None
    frac = kmer_absent_fraction(x_aug, sx, k=cfg.probe_kmer,
                                samples=cfg.probe_samples,
                                ref_cap=cfg.probe_ref_cap)
    if mgr is not None:
        try:
            mgr.save("probe", fp,
                     {"frac": np.float64(-1.0 if frac is None else frac)})
        except Exception:
            pass
    return frac


def _resolve_backend(backend: str, coll_chars: int | None = None,
                     x_aug=None, sx=None, cfg=None,
                     ref_path=None, coll_path=None) -> str:
    """auto dispatch, with the divergence probe:

    * accelerator + LOW divergence (k-mer absence below
      cfg.probe_threshold, engine/probe.py) -> the native PLCP-skip scan
      engine: this regime is sequential-latency-bound, and an
      OpenMP-threaded scan is expected to beat the lane-parallel device
      formulations (the crossover awaits an H100 measurement);
    * accelerator otherwise -> dense (joint sort, divergence-insensitive);
    * CPU-only -> native when the toolchain built the scan engine, else
      the jump XLA scan; tiny inputs -> native/host (dispatch overheads
      dominate any device path below the crossover)."""
    if backend != "auto":
        return backend

    def _native_ok() -> bool:
        from ..io.native import get_scan_lib
        return get_scan_lib() is not None

    if coll_chars is not None and coll_chars < AUTO_DENSE_MIN_CHARS:
        return "native" if _native_ok() else "host"
    if _on_accelerator():
        if (x_aug is not None and sx is not None and cfg is not None
                and _native_ok()):
            frac = _probe_cached(cfg, x_aug, sx, ref_path, coll_path)
            if frac is not None and frac < cfg.probe_threshold:
                return "native"
        return "dense"
    return "native" if _native_ok() else "jump"


def _build_host_index_fast(x_aug: np.ndarray) -> ReferenceIndex:
    """Host ReferenceIndex for the native scan engine: built on the
    accelerator (device doubling + one download) when present — the numpy
    doubling build is ~10x slower at Mbp scale — else on the host. Cached
    on disk by the caller (cfg.index_cache_dir), so steady-state runs skip
    the build entirely."""
    if _on_accelerator():
        from ..index.device import build_device_index
        return _export_device_index(build_device_index(x_aug), x_aug)
    return build_reference_index(x_aug)


def _index_from_arrays(x_aug: np.ndarray, arrays: dict) -> ReferenceIndex:
    """ReferenceIndex from a ref_index checkpoint bundle (rank_history is
    a build intermediate — no downstream consumer, not persisted)."""
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=len(x_aug), sa=arrays["sa"], isa=arrays["isa"],
        lcp=arrays["lcp"], plcp=arrays["plcp"], bwt=arrays["bwt"],
        rank_history=[])


def _export_device_index(dindex, x_aug: np.ndarray) -> ReferenceIndex:
    """Host view of a device-built index (downstream numpy stages)."""
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=dindex.n,
        sa=np.asarray(dindex.sa),
        isa=np.asarray(dindex.isa),
        lcp=np.asarray(dindex.lcp),
        plcp=np.asarray(dindex.plcp),
        bwt=np.asarray(dindex.bwt),
        rank_history=[],
    )
