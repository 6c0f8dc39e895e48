"""Host matching-statistics scan — the semantic specification of the MS
factorizer (ref ``computeMSFactorAt`` CMS-BWT-functions.cpp:45-88, the binary
searches :94-149, and the per-document driver loop :357-403/:491-556).

The device (JAX) scans in ``cmsbwt_tpu/ops`` are validated against this
implementation. MS values (pos, len, smaller) at each position are pure
functions of (index, text) — history only accelerates the scan — which is
what makes the scan block-parallel on a device.

Output arrays over the whole concatenated collection SX (length sn):

* ``pos``      int64: match position in the reference (n-1 at separators)
* ``length``   int64: match length (0 at separators)
* ``smaller``  bool:  collection suffix < best-matching reference suffix
* ``is_head``  bool:  phrase head (pos != prevPos+1, doc starts, separators)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import SEPARATOR
from ..index.host import ReferenceIndex


@dataclass
class MSArrays:
    pos: np.ndarray
    length: np.ndarray
    smaller: np.ndarray
    is_head: np.ndarray


def _binary_search_lb(xp: np.ndarray, sa: np.ndarray, lo: int, hi: int,
                      offset: int, c: int) -> int:
    """Leftmost SA slot in [lo,hi] with x[SA[m]+offset] == c, else
    -(insertion_point+1) (ref :94-120)."""
    low, high = lo, hi
    while low <= high:
        mid = (low + high) >> 1
        mv = xp[sa[mid] + offset]
        if mv < c:
            low = mid + 1
        elif mv > c:
            high = mid - 1
        else:
            if mid == lo or xp[sa[mid - 1] + offset] != mv:
                return mid
            high = mid - 1
    return -(low + 1)


def _binary_search_rb(xp: np.ndarray, sa: np.ndarray, lo: int, hi: int,
                      offset: int, c: int) -> int:
    """Rightmost SA slot (ref :123-149)."""
    low, high = lo, hi
    while low <= high:
        mid = (low + high) >> 1
        mv = xp[sa[mid] + offset]
        if mv < c:
            low = mid + 1
        elif mv > c:
            high = mid - 1
        else:
            if mid == hi or xp[sa[mid + 1] + offset] != mv:
                return mid
            low = mid + 1
    return -(low + 1)


def compute_ms_factor_at(index: ReferenceIndex, content: np.ndarray, i: int,
                         length: int, left_b: int, right_b: int
                         ) -> tuple[int, int, int, int, bool]:
    """Port of computeMSFactorAt (ref :45-88).

    Extends the match of content[i..] from offset ``length`` with SA interval
    [left_b, right_b]. Returns (pos, len, leftB, rightB, smaller). leftB and
    rightB are only updated while the interval refines (exactly as the
    by-reference parameters in the C++).
    """
    xp = index.x_padded
    sa = index.sa
    sn = len(content)
    offset = length
    j = i + offset
    nlb, nrb = left_b, right_b
    match = int(sa[nlb])
    smaller = False
    while j < sn:
        c = int(content[j])
        if nlb == nrb:
            rc = int(xp[sa[nlb] + offset])
            if rc != c:
                smaller = rc > c
                break
            left_b = nlb
            right_b = nrb
        else:
            nlb2 = _binary_search_lb(xp, sa, nlb, nrb, offset, c)
            if nlb2 < 0:
                max_match = -nlb2 - 1
                smaller = True
                if max_match == nrb + 1:
                    max_match -= 1
                    smaller = False
                match = int(sa[max_match])
                break
            nlb = nlb2
            nrb = _binary_search_rb(xp, sa, nlb, nrb, offset, c)
            left_b = nlb
            right_b = nrb
        match = int(sa[nlb])
        j += 1
        offset += 1
    return match, offset, left_b, right_b, smaller


def ms_scan_document(index: ReferenceIndex, content: np.ndarray,
                     out_pos: np.ndarray, out_len: np.ndarray,
                     out_smaller: np.ndarray, out_head: np.ndarray,
                     base: int) -> None:
    """Scan one separator-terminated document; fill the output slices at
    [base, base+len(content)). Ref driver loop :357-403.

    The final position (the separator) receives the pseudo-head
    (pos=n-1, len=0, smaller=False) (ref :404-409).
    """
    n = index.n
    plcp = index.plcp
    L = len(content)
    i = 0
    left_b, right_b = 0, n - 1
    prev_pos = -2
    pos, length = n - 1, 0
    while i < L - 1:
        pos, length, left_b, right_b, smaller = compute_ms_factor_at(
            index, content, i, length, left_b, right_b)
        out_pos[base + i] = pos
        out_len[base + i] = length
        out_smaller[base + i] = smaller
        out_head[base + i] = pos != prev_pos + 1
        length -= 1
        if left_b == right_b:
            # PLCP skip run (ref :381-391), vectorized: find the first k
            # where (length - k) <= plcp[pos + 1 + k]; all positions before
            # that are guaranteed singleton tails.
            if length > plcp[pos + 1]:
                w = min(length, L - 1 - (i + 1) + length)  # safe upper bound
                # run length r = count of consecutive k with
                #   length - k > plcp[pos+1+k]
                kmax = min(length, n - 2 - pos)
                ks = np.arange(kmax, dtype=np.int64)
                okay = (length - ks) > plcp[pos + 1 + ks]
                r = int(np.argmin(okay)) if not okay.all() else kmax
                # emit r skipped tail positions
                idxs = np.arange(1, r + 1, dtype=np.int64)
                out_pos[base + i + idxs] = pos + idxs
                out_len[base + i + idxs] = length - idxs + 1
                out_smaller[base + i + idxs] = False
                out_head[base + i + idxs] = False
                i += r
                pos += r
                length -= r
            left_b, right_b = index.adjust_interval(
                int(index.isa[pos + 1]), int(index.isa[pos + 1]), length)
        else:
            left_b, right_b = index.contract_left(left_b, right_b, length)
        i += 1
        prev_pos = pos
    # pseudo-head at the separator position (ref :404-409)
    out_pos[base + L - 1] = n - 1
    out_len[base + L - 1] = 0
    out_smaller[base + L - 1] = False
    out_head[base + L - 1] = True


def ms_scan_collection(index: ReferenceIndex, sx: np.ndarray,
                       sep_positions: np.ndarray) -> MSArrays:
    """Scan the full collection SX document by document."""
    sn = len(sx)
    pos = np.empty(sn, dtype=np.int64)
    length = np.empty(sn, dtype=np.int64)
    smaller = np.zeros(sn, dtype=bool)
    head = np.zeros(sn, dtype=bool)
    start = 0
    for sep in sep_positions:
        sep = int(sep)
        ms_scan_document(index, sx[start: sep + 1], pos, length, smaller,
                         head, start)
        start = sep + 1
    return MSArrays(pos=pos, length=length, smaller=smaller, is_head=head)


def naive_ms_at(index: ReferenceIndex, content: np.ndarray, i: int) -> tuple[int, int]:
    """Oracle: longest match of content[i..] (stopping before the final
    separator comparison rules) against any reference position — O(n * len)
    brute force for tests."""
    x = index.x
    n = index.n
    best_len = 0
    best_pos = 0
    limit = len(content) - i
    for p in range(n):
        l = 0
        while (l < limit and p + l < n and content[i + l] == x[p + l]):
            l += 1
        if l > best_len:
            best_len = l
            best_pos = p
    return best_pos, best_len
