// Native matching-statistics scan engine — the host-side fast path for
// LOW-DIVERGENCE collections (the reference's strongest regime).
//
// Why this exists beside the device pipeline: the compressed-MS trick (PLCP
// skip, ref CMS-BWT-functions.cpp:381-395) makes per-phrase work O(1)
// amortized, so at ~0.1% divergence a single CPU core streams tens of
// Mchars/s while an accelerator formulation is bound by sequential gather
// latency per phrase (where the GPU jump scan crosses this engine awaits
// an H100 measurement).  The framework therefore treats this regime like
// the SARS merge shape: the auto dispatcher routes it to this native engine
// (OpenMP over documents), while high-divergence inputs keep the dense
// device pipeline.
//
// Provenance: this file is a C++ transcription of THIS PROJECT's spec
// engine, cmsbwt_tpu/engine/ms_host.py (which documents the semantics of
// ref computeMSFactorAt :45-88, binary searches :94-149, driver loop
// :357-403 — byte-equality against the reference binary leaves zero
// semantic slack, so any correct engine computes the same factor chain).
// Structure differs from the reference's: head records only (no tail
// emission, no bucketsForExpandedBWT sign-coding — tails are derived by
// the merge from head spans), documents scanned by OpenMP threads into
// per-document vectors, templated index type (int32/int64), and PSV/NSV
// served by an original three-level block-minima structure (64-element
// blocks, 64-block superblocks) instead of the reference's rmq_tree.
//
// Build: g++ -O3 -shared -fPIC -fopenmp (io/native.py on-demand builder).
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Rec {
    int64_t t;
    int64_t pos;
    int64_t len;
    uint8_t smaller;
};

template <typename IdxT>
struct BlockMin {
    // three-level minima over lcp[0..n] (length n+1, lcp[n] = -1)
    static constexpr int64_t B = 64;
    const IdxT* lcp;
    int64_t n1;  // n + 1
    std::vector<IdxT> blk;   // ceil(n1/B)
    std::vector<IdxT> sup;   // ceil(blk/B)

    void build(const IdxT* lcp_, int64_t n1_) {
        lcp = lcp_;
        n1 = n1_;
        const IdxT IMAX = std::numeric_limits<IdxT>::max();
        int64_t nb = (n1 + B - 1) / B;
        blk.assign(nb, IMAX);
        for (int64_t b = 0; b < nb; b++) {
            int64_t lo = b * B, hi = std::min(n1, lo + B);
            IdxT m = IMAX;
            for (int64_t j = lo; j < hi; j++) m = std::min(m, lcp[j]);
            blk[b] = m;
        }
        int64_t ns = (nb + B - 1) / B;
        sup.assign(ns, IMAX);
        for (int64_t s = 0; s < ns; s++) {
            int64_t lo = s * B, hi = std::min<int64_t>(nb, lo + B);
            IdxT m = IMAX;
            for (int64_t b = lo; b < hi; b++) m = std::min(m, blk[b]);
            sup[s] = m;
        }
    }

    // max j <= i with lcp[j] < ub, else -1   (index/host.py psv semantics)
    int64_t psv(int64_t i, IdxT ub) const {
        if (i < 0) return -1;
        if (i >= n1) i = n1 - 1;
        int64_t b = i / B;
        for (int64_t j = i; j >= b * B; j--)
            if (lcp[j] < ub) return j;
        int64_t s = b / B;
        // remaining blocks in this superblock
        for (int64_t bb = b - 1; bb >= s * B; bb--) {
            if (blk[bb] < ub) {
                for (int64_t j = std::min(n1, (bb + 1) * B) - 1;
                     j >= bb * B; j--)
                    if (lcp[j] < ub) return j;
            }
        }
        for (int64_t ss = s - 1; ss >= 0; ss--) {
            if (sup[ss] < ub) {
                for (int64_t bb = std::min<int64_t>((int64_t)blk.size(),
                                                    (ss + 1) * B) - 1;
                     bb >= ss * B; bb--) {
                    if (blk[bb] < ub) {
                        for (int64_t j = std::min(n1, (bb + 1) * B) - 1;
                             j >= bb * B; j--)
                            if (lcp[j] < ub) return j;
                    }
                }
            }
        }
        return -1;
    }

    // min j >= i with lcp[j] < ub and j < limit, else -1  (nsv: limit = n)
    int64_t nsv(int64_t i, IdxT ub, int64_t limit) const {
        if (i >= limit) return -1;
        if (i < 0) i = 0;
        int64_t b = i / B;
        int64_t bend = std::min(limit, (b + 1) * B);
        for (int64_t j = i; j < bend; j++)
            if (lcp[j] < ub) return j;
        int64_t nb = (limit + B - 1) / B;
        int64_t s = b / B;
        for (int64_t bb = b + 1; bb < std::min(nb, (s + 1) * B); bb++) {
            if (blk[bb] < ub) {
                int64_t hi = std::min(limit, (bb + 1) * B);
                for (int64_t j = bb * B; j < hi; j++)
                    if (lcp[j] < ub) return j;
            }
        }
        int64_t ns = (nb + B - 1) / B;
        for (int64_t ss = s + 1; ss < ns; ss++) {
            if (sup[ss] < ub) {
                for (int64_t bb = ss * B;
                     bb < std::min(nb, (ss + 1) * B); bb++) {
                    if (blk[bb] < ub) {
                        int64_t hi = std::min(limit, (bb + 1) * B);
                        for (int64_t j = bb * B; j < hi; j++)
                            if (lcp[j] < ub) return j;
                    }
                }
            }
        }
        return -1;
    }
};

template <typename IdxT>
struct Ctx {
    const uint8_t* xp;     // x_padded, length n+1
    const IdxT* sa;
    const IdxT* isa;
    const IdxT* plcp;
    int64_t n;
    const BlockMin<IdxT>* bm;
};

// leftmost SA slot in [lo,hi] with xp[sa[m]+offset] == c, else
// -(insertion_point+1)   (ms_host._binary_search_lb)
template <typename IdxT>
static inline int64_t bs_lb(const Ctx<IdxT>& C, int64_t lo, int64_t hi,
                           int64_t offset, int c) {
    int64_t low = lo, high = hi;
    while (low <= high) {
        int64_t mid = (low + high) >> 1;
        int mv = C.xp[(int64_t)C.sa[mid] + offset];
        if (mv < c) low = mid + 1;
        else if (mv > c) high = mid - 1;
        else {
            if (mid == lo || C.xp[(int64_t)C.sa[mid - 1] + offset] != mv)
                return mid;
            high = mid - 1;
        }
    }
    return -(low + 1);
}

template <typename IdxT>
static inline int64_t bs_rb(const Ctx<IdxT>& C, int64_t lo, int64_t hi,
                           int64_t offset, int c) {
    int64_t low = lo, high = hi;
    while (low <= high) {
        int64_t mid = (low + high) >> 1;
        int mv = C.xp[(int64_t)C.sa[mid] + offset];
        if (mv < c) low = mid + 1;
        else if (mv > c) high = mid - 1;
        else {
            if (mid == hi || C.xp[(int64_t)C.sa[mid + 1] + offset] != mv)
                return mid;
            low = mid + 1;
        }
    }
    return -(low + 1);
}

template <typename IdxT>
static inline void adjust_interval(const Ctx<IdxT>& C, int64_t lo, int64_t hi,
                                   int64_t offset, int64_t* out_lo,
                                   int64_t* out_hi) {
    int64_t p = C.bm->psv(lo, (IdxT)offset);
    if (p == -1) p = 0;
    int64_t q = C.bm->nsv(hi + 1, (IdxT)offset, C.n);
    q = (q == -1) ? C.n - 1 : q - 1;
    *out_lo = p;
    *out_hi = q;
}

template <typename IdxT>
static inline void contract_left(const Ctx<IdxT>& C, int64_t lo, int64_t hi,
                                 int64_t offset, int64_t* out_lo,
                                 int64_t* out_hi) {
    int64_t suflo = C.sa[lo], sufhi = C.sa[hi];
    if (suflo == C.n - 1 || sufhi == C.n - 1) {
        *out_lo = 0;
        *out_hi = C.n - 1;
        return;
    }
    adjust_interval(C, C.isa[suflo + 1], C.isa[sufhi + 1], offset,
                    out_lo, out_hi);
}

// ms_host.compute_ms_factor_at (ref computeMSFactorAt :45-88)
template <typename IdxT>
static void ms_factor_at(const Ctx<IdxT>& C, const uint8_t* content, int64_t L,
                         int64_t i, int64_t length, int64_t* left_b,
                         int64_t* right_b, int64_t* out_pos,
                         int64_t* out_len, uint8_t* out_smaller) {
    int64_t offset = length;
    int64_t j = i + offset;
    int64_t nlb = *left_b, nrb = *right_b;
    int64_t match = C.sa[nlb];
    uint8_t smaller = 0;
    while (j < L) {
        int c = content[j];
        if (nlb == nrb) {
            int rc = C.xp[(int64_t)C.sa[nlb] + offset];
            if (rc != c) {
                smaller = rc > c;
                break;
            }
            *left_b = nlb;
            *right_b = nrb;
        } else {
            int64_t nlb2 = bs_lb(C, nlb, nrb, offset, c);
            if (nlb2 < 0) {
                int64_t max_match = -nlb2 - 1;
                smaller = 1;
                if (max_match == nrb + 1) {
                    max_match -= 1;
                    smaller = 0;
                }
                match = C.sa[max_match];
                break;
            }
            nlb = nlb2;
            nrb = bs_rb(C, nlb, nrb, offset, c);
            *left_b = nlb;
            *right_b = nrb;
        }
        match = C.sa[nlb];
        j += 1;
        offset += 1;
    }
    *out_pos = match;
    *out_len = offset;
    *out_smaller = smaller;
}

// one separator-terminated document (ms_host.ms_scan_document), emitting
// HEAD records only: the PLCP skip run slides over tails without storing
// them (the merge derives tails from head spans)
template <typename IdxT>
static void scan_document(const Ctx<IdxT>& C, const uint8_t* content, int64_t L,
                          int64_t base, std::vector<Rec>& out) {
    const IdxT* plcp = C.plcp;
    int64_t n = C.n;
    int64_t i = 0;
    int64_t left_b = 0, right_b = n - 1;
    int64_t prev_pos = -2;
    int64_t pos = n - 1, length = 0;
    while (i < L - 1) {
        uint8_t smaller;
        ms_factor_at(C, content, L - 1 + 1, i, length, &left_b, &right_b,
                     &pos, &length, &smaller);
        if (pos != prev_pos + 1)
            out.push_back(Rec{base + i, pos, length, smaller});
        length -= 1;
        if (left_b == right_b) {
            if (length > plcp[pos + 1]) {
                // PLCP skip run (ref :381-391): r = count of leading k with
                // (length - k) > plcp[pos+1+k]
                int64_t kmax = std::min(length, n - 2 - pos);
                int64_t r = 0;
                while (r < kmax && (length - r) > plcp[pos + 1 + r]) r++;
                i += r;
                pos += r;
                length -= r;
            }
            adjust_interval(C, C.isa[pos + 1], C.isa[pos + 1], length,
                            &left_b, &right_b);
        } else {
            contract_left(C, left_b, right_b, length, &left_b, &right_b);
        }
        i += 1;
        prev_pos = pos;
    }
    // pseudo-head at the separator (ref :404-409)
    out.push_back(Rec{base + L - 1, n - 1, 0, 0});
}

template <typename IdxT>
static int64_t scan_all(const uint8_t* x_padded, const IdxT* sa,
                        const IdxT* isa, const IdxT* lcp,
                        const IdxT* plcp, int64_t n, const uint8_t* sx,
                        int64_t sn, const int64_t* doc_ends, int32_t n_docs,
                        int64_t cap, int64_t* head_t, int64_t* head_pos,
                        int64_t* head_len, uint8_t* head_smaller,
                        int32_t nthreads) {
    BlockMin<IdxT> bm;
    bm.build(lcp, n + 1);
    Ctx<IdxT> C{x_padded, sa, isa, plcp, n, &bm};
    std::vector<std::vector<Rec>> per_doc(n_docs);
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t d = 0; d < n_docs; d++) {
        int64_t start = d == 0 ? 0 : doc_ends[d - 1] + 1;
        int64_t end = doc_ends[d];  // separator position
        scan_document(C, sx + start, end - start + 1, start, per_doc[d]);
    }
    int64_t total = 0;
    for (auto& v : per_doc) total += (int64_t)v.size();
    if (total > cap) return -total;
    int64_t k = 0;
    for (auto& v : per_doc) {
        for (auto& r : v) {
            head_t[k] = r.t;
            head_pos[k] = r.pos;
            head_len[k] = r.len;
            head_smaller[k] = r.smaller;
            k++;
        }
    }
    return total;
}

}  // namespace

extern "C" {

// Scan the collection (documents delimited by doc_ends) and emit head
// records.  Returns the head count on success; -(needed) if cap was too
// small (caller reallocates and retries — nothing was written).
int64_t cms_ms_scan(const uint8_t* x_padded, const int32_t* sa,
                    const int32_t* isa, const int32_t* lcp,
                    const int32_t* plcp, int32_t n, const uint8_t* sx,
                    int64_t sn, const int64_t* doc_ends, int32_t n_docs,
                    int64_t cap, int64_t* head_t, int64_t* head_pos,
                    int64_t* head_len, uint8_t* head_smaller,
                    int32_t nthreads) {
    return scan_all<int32_t>(x_padded, sa, isa, lcp, plcp, n, sx, sn,
                             doc_ends, n_docs, cap, head_t, head_pos,
                             head_len, head_smaller, nthreads);
}

// int64-indexed variant: the giant-reference route (n >= 2^31; the
// sharded int64 mesh index feeds this engine — the reference tool's own
// int32 libsais cap is the bound being lifted, ref
// CMS-BWT-functions.cpp:246)
int64_t cms_ms_scan_i64(const uint8_t* x_padded, const int64_t* sa,
                        const int64_t* isa, const int64_t* lcp,
                        const int64_t* plcp, int64_t n, const uint8_t* sx,
                        int64_t sn, const int64_t* doc_ends,
                        int32_t n_docs, int64_t cap, int64_t* head_t,
                        int64_t* head_pos, int64_t* head_len,
                        uint8_t* head_smaller, int32_t nthreads) {
    return scan_all<int64_t>(x_padded, sa, isa, lcp, plcp, n, sx, sn,
                             doc_ends, n_docs, cap, head_t, head_pos,
                             head_len, head_smaller, nthreads);
}

}  // extern "C"
