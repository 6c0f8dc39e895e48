"""Head ranking: class rank assignment, head-string suffix sort, successor
re-ranking (ref ``CMS-BWT-functions.cpp:627-695``).

The reference walks reference positions in SA order assigning consecutive
integer ranks to classes (doc-end pseudo-heads get one rank per member, doc
order, ref :630-643), builds the text-order integer string ``rankToHead``
over head indices, suffix-sorts it with ``libsais_int`` (ref :648) — the
ESA'23 trick: equal-class heads are tie-broken by the remainder of the head
sequence, which equals collection suffix order — and derives the head BWT
plus each head's final rank.

Here the integer suffix sort is the same prefix-doubling pipeline used for
the reference index (``cmsbwt_tpu/index``), and rank assignment is pure
index arithmetic over the class arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.host import ReferenceIndex, suffix_array_doubling
from ..io.native import (argsort_native, fill_class_ranks_native,
                         lexsort2_native)
from .heads import ClassArrays, HeadArrays


@dataclass
class RankedHeads:
    final_rank: np.ndarray   # int64 [h]: final sorted rank of each head idx
    bwt_heads: np.ndarray    # uint8 [h]: head BWT char by final rank
    succ_rank: np.ndarray    # int64 [h]: final rank of the covering successor
    slot_of_head: np.ndarray  # int64 [h]: global slot (text-order layout)
    slot_base: np.ndarray    # int64 [C+1]: slot range begin per text-order class
    member_rank_sorted: np.ndarray  # int64 [h]: per-class ascending succ ranks
                                    # aligned with slots
    sa_ord: np.ndarray       # int64 [C]: classes in SA-walk order (cached
                             # for build_runs — avoids re-sorting)


def class_sa_order(index: ReferenceIndex, classes: ClassArrays) -> np.ndarray:
    """Classes ordered by (ISA[pos], comparator) — the rank-assignment walk
    order (ref :630-643). Returns a permutation of text-order class ids."""
    isa_pos = index.isa[classes.pos].astype(np.int64)
    scale = np.int64(index.n + 1)
    return lexsort2_native(isa_pos,
                           classes.key_k * scale + classes.isa_next)


def assign_class_ranks(index: ReferenceIndex, classes: ClassArrays,
                       heads: HeadArrays, d: int) -> np.ndarray:
    """rankToHead (text order over head idx) + terminating 0 (ref :628-645).

    Class at sa-order position 0 is the pseudo class (pos = n-1, ISA 0): its
    members get ranks 1..D-1 in idx (=document) order; class c >= 1 maps to
    rank D + c.
    """
    sa_ord = class_sa_order(index, classes)
    rank_to_head = np.zeros(heads.h + 1, dtype=np.int64)
    # pseudo class must be first
    pseudo_cls = sa_ord[0]
    assert classes.length[pseudo_cls] == 0, "pseudo class not first in SA order"
    mo, hi = classes.member_off[pseudo_cls], classes.member_off[pseudo_cls + 1]
    pseudo_members = classes.member_head[mo:hi]       # ascending idx (doc order)
    rank_to_head[pseudo_members] = 1 + np.arange(len(pseudo_members))
    # other classes: rank D + c  (c = 1-based position in sa order minus 0)
    rank_value = np.empty(classes.n_classes, dtype=np.int64)
    rank_value[sa_ord] = np.arange(classes.n_classes) + d
    rank_value[pseudo_cls] = 0                         # members set individually
    if not fill_class_ranks_native(classes.member_off, classes.member_head,
                                   rank_value, pseudo_cls, rank_to_head):
        for_cls = np.repeat(np.arange(classes.n_classes),
                            np.diff(classes.member_off))
        nonpseudo = for_cls != pseudo_cls
        rank_to_head[classes.member_head[nonpseudo]] = \
            rank_value[for_cls[nonpseudo]]
    rank_to_head[heads.h] = 0
    return rank_to_head, sa_ord


DEVICE_SORT_THRESHOLD = 200_000


def _head_string_suffix_sort(rank_to_head: np.ndarray) -> np.ndarray:
    """Suffix sort of the head rank string (replaces libsais_int, ref :648).

    Large head strings go through the device prefix-doubling pipeline; small
    ones stay on host (kernel launch overhead dominates below ~200K).
    """
    L = len(rank_to_head)
    if L > DEVICE_SORT_THRESHOLD:
        try:
            import jax.numpy as jnp

            from ..index.device import suffix_array_device
            from ..utils.jaxcache import bucket_size
            BIG = np.int32(1 << 30)
            L_pad = bucket_size(L)
            if L_pad < (1 << 30) and int(rank_to_head.max(initial=0)) < BIG:
                # bucket-pad so repeat runs with nearby head counts reuse
                # ONE compiled program (an exact-length shape recompiles
                # for every new collection): pad
                # positions get distinct ascending symbols above every
                # real rank, so their suffixes resolve immediately and
                # sort after all real ones (head_string_sa_dev's trick)
                s = np.empty(L_pad, np.int32)
                s[:L] = rank_to_head
                s[L:] = BIG + np.arange(L, L_pad, dtype=np.int32)
                sa, _, _, _ = suffix_array_device(jnp.asarray(s), L_pad)
                sa_np = np.asarray(sa)
                return sa_np[sa_np < L]
            sa, _, _, _ = suffix_array_device(
                jnp.asarray(rank_to_head.astype(np.int32)), L)
            return np.asarray(sa)
        except Exception:
            pass
    head_to_rank, _, _ = suffix_array_doubling(rank_to_head)
    return head_to_rank


def rank_heads(index: ReferenceIndex, classes: ClassArrays, heads: HeadArrays,
               d: int) -> RankedHeads:
    rank_to_head, sa_ord = assign_class_ranks(index, classes, heads, d)
    head_to_rank = _head_string_suffix_sort(rank_to_head)
    # final rank: skip the terminator suffix at SA position 0
    sa_body = head_to_rank[1:].astype(np.int64)        # length h
    final_rank = np.empty(heads.h, dtype=np.int64)
    final_rank[sa_body] = np.arange(heads.h)
    bwt_heads = heads.char[sa_body]
    succ_rank = final_rank[heads.succ]

    # slot layout: classes in text order, members by ascending succ rank
    # (ref idx-list sort :685 + prefixSumForPositions :697-707)
    slot_base = classes.member_off.copy()
    member_rank = succ_rank[classes.member_head]
    # sort members within each class by succ rank
    cls_of_member = np.repeat(np.arange(classes.n_classes),
                              np.diff(classes.member_off))
    # single-key argsort on packed (class, rank)
    order = argsort_native(cls_of_member * np.int64(heads.h + 1)
                           + member_rank)
    member_rank_sorted = member_rank[order]
    member_head_sorted = classes.member_head[order]
    slot_of_head = np.empty(heads.h, dtype=np.int64)
    slot_of_head[member_head_sorted] = np.arange(heads.h)

    return RankedHeads(
        final_rank=final_rank,
        bwt_heads=bwt_heads,
        succ_rank=succ_rank,
        slot_of_head=slot_of_head,
        slot_base=slot_base,
        member_rank_sorted=member_rank_sorted,
        sa_ord=sa_ord,
    )
