"""Divergence probe for backend auto-dispatch.

The CMS-BWT workload has two perf regimes (ref
``CMS-BWT-functions.cpp:381-395``):

* LOW divergence (pangenome-like, ~0.1% SNP): phrases are long, the
  reference's PLCP-skip makes per-phrase work O(1) amortized, and a
  sequential pointer-chasing scan streams tens of Mchars/s.  Any
  accelerator formulation is bound by dependent gather latency per
  phrase, so the framework routes this regime to the native OpenMP scan
  engine (native/cmsbwt_scan.cpp) — the same host-routing policy the
  merge already applies to the SARS shape.
* HIGH divergence: phrases are short, per-character work dominates, and
  the dense joint-sort device pipeline (ops/ms_dense) wins.

The probe estimates divergence WITHOUT an index: the fraction of sampled
collection k-mers absent from the reference's k-mer set.  With SNP rate
s and k-mer length k, the absent fraction is ~1-(1-s)^k (k=24: 0.1% SNP
-> ~2.4%, 1% -> ~21%, 5% -> ~71%).  The default threshold 0.72 (~5-6%
SNP at the 20 Mchar primary shape) is where the native and dense engines
were expected to cross; it awaits an H100 measurement (see
config.probe_threshold).  Cost: one pass over the reference
plus a 65536-sample gather — a few hundred ms at an 8 Mbp cap, charged
once per (reference, collection) pair (results are stamp-cached).
"""
from __future__ import annotations

import numpy as np

_B = np.uint64(1099511628211)  # FNV-ish odd multiplier (wraparound mod 2^64)


def _kmer_hashes_sliding(x: np.ndarray, k: int) -> np.ndarray:
    """Polynomial hashes of every length-k window of ``x`` (vectorized)."""
    n = len(x)
    if n < k:
        return np.zeros(0, np.uint64)
    h = np.zeros(n - k + 1, np.uint64)
    for j in range(k):
        h = h * _B + x[j: n - k + 1 + j].astype(np.uint64)
    return h


def kmer_absent_fraction(x_aug: np.ndarray, sx: np.ndarray, k: int = 24,
                         samples: int = 1 << 16,
                         ref_cap: int = 8 << 20) -> float | None:
    """Fraction of sampled collection k-mers absent from the reference,
    or None when the probe does not apply (tiny/huge inputs)."""
    n = len(x_aug)
    sn = len(sx)
    if n > ref_cap or n < 4 * k or sn < 4 * k:
        return None
    ref_h = np.sort(_kmer_hashes_sliding(np.asarray(x_aug), k))
    m = min(samples, sn - k + 1)
    pos = np.linspace(0, sn - k, m).astype(np.int64)
    win = np.asarray(sx)[pos[:, None] + np.arange(k)[None, :]]
    h = np.zeros(m, np.uint64)
    for j in range(k):
        h = h * _B + win[:, j].astype(np.uint64)
    idx = np.searchsorted(ref_h, h)
    idx = np.clip(idx, 0, len(ref_h) - 1)
    present = ref_h[idx] == h
    return float(1.0 - present.mean())
