"""Configuration for the CMS-BWT JAX framework.

Mirrors the reference CLI contract (``/root/reference/utils.h:8-14`` and
``/root/reference/main.cpp:37-70``) while exposing every hard-coded constant of
the reference as a named field (ref ``CMS-BWT-functions.cpp:341,1131,1792``,
``CMS-BWT.h:28``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Reserved alphabet values (ref CMS-BWT.h:28 and CMS-BWT-functions.cpp:231-237).
TERMINATOR = 0          # appended last to the augmented reference
PRE_TERMINATOR = 1      # appended second-to-last
SEPARATOR = 2           # document separator in the collection
ALPHABET_AUGMENT_LO = 3     # chars [3, 128) absent from the reference are appended
ALPHABET_AUGMENT_HI = 128   # (ref loops i in [3, sizeChars/2) with sizeChars=256)

UINT64_MAX = 2**64 - 1


@dataclasses.dataclass
class Config:
    """Run configuration (CLI-compatible with the reference's ``Args``)."""

    # --- reference-compatible flags (main.cpp:37-70) ---
    filename: str = ""              # input list file: line1=ref path, line2=collection path
    outname: str = ""               # output basename (default: filename)
    rle: bool = False               # -r : emit .rl_bwt instead of .bwt
    buffer_gib: int = 2             # -b : bounds the tail-positioning batch
                                    # working set (the reference's only use of
                                    # arg.buffer: the bufferSuffixes cap,
                                    # ref :713-719)
    prefix_length: int = UINT64_MAX  # -p : prefix of the collection file to process

    # --- reference-internal constants, surfaced (CMS-BWT-functions.cpp) ---
    small_ref_threshold: int = 1_000_000   # small vs large dispatch (:1792)
    chunk_cap_bytes: int = 1_000_000_000   # phrase-chunk spill cap (:341, :1131)
                                    # here: caps the derived per-device block
                                    # size when --parallel picks one
    write_buffer_bytes: int = 1 << 20      # output write buffer (:943);
                                    # chunk size of the fallback writers

    # --- device knobs (no reference equivalent) ---
    backend: str = "auto"           # "host", "device", "dense" (joint
                                    # sort), "jump" (head-jumping), "auto"
    lanes: int = 4096               # parallel MS cursors per device
                                    # (awaits an H100 sweep)
    skip_window: int = 64           # vectorized memcmp window (device/jump)
    dense_block_chars: Optional[int] = None  # None = single joint sort;
                                    # else stream the collection in blocks
    dense_parallel: bool = False    # fan blocks out over all local devices
    dense_ctx_chars: Optional[int] = None    # right-context per block
    merge_backend: str = "auto"     # downstream merge engine: "host" (numpy
                                    # + native OpenMP), "device" (sorted
                                    # joins on the accelerator), "sharded"
                                    # (mesh sample-sort joins, int64-safe,
                                    # parallel/sharded_merge.py), "auto"
    checkpoint_dir: Optional[str] = None  # phase-boundary checkpoint/resume
    replicate_reference_rle_quirk: bool = True  # reproduce ref RLE residual quirk
                                    # (see merge.py; ref :1069-1078 vs :986-994)

    # --- reference-index cache + auto-dispatch probe ---
    # The reference index depends only on the reference file, so it is
    # cached on disk by default (bwa/bowtie-style one-time indexing; the
    # reference binary rebuilds its index every run).  "" disables.
    index_cache_dir: Optional[str] = None   # None -> CMSBWT_INDEX_CACHE or
                                            # ~/.cache/cmsbwt_tpu/ref_index
    # k-mer absence probe steering backend="auto" (engine/probe.py): below
    # the threshold the collection routes to the native PLCP-skip scan
    # engine; above it the dense device pipeline wins. 0.72 is the 24-mer
    # absent fraction of ~5-6% SNP, where the engines were expected to
    # cross at the 20 Mchar primary shape; the value awaits an H100
    # measurement of both engines
    probe_threshold: float = 0.72
    probe_kmer: int = 24
    probe_ref_cap: int = 8 << 20    # skip the probe above this ref size
    probe_samples: int = 1 << 16

    def resolved_outname(self) -> str:
        return self.outname if self.outname else self.filename

    def resolved_index_cache_dir(self) -> Optional[str]:
        """Index-cache directory or None when disabled."""
        import os
        if self.index_cache_dir == "":
            return None
        if self.index_cache_dir:
            return self.index_cache_dir
        env = os.environ.get("CMSBWT_INDEX_CACHE")
        if env == "":
            return None
        return env or os.path.expanduser("~/.cache/cmsbwt_tpu/ref_index")
