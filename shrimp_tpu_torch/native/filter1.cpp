// Native host filter 1: spaced-kmer lookup -> region prefilter -> anchor
// collapse -> candidate window generation, for a whole read batch.
//
// Semantically identical to core/batch_pipeline.py::generate_candidates
// (itself element-equal to SHRiMP2's read_get_mapidxs /
// read_get_region_counts / read_get_anchor_list / read_get_hit_list,
// gmapper/mapping.c) — this is the production host path; the numpy
// implementation remains as the readable reference and fallback.
//
// Built as a plain C extension (no pybind11 in this image); the Python
// wrapper passes raw buffers via ctypes.
//
// Two entry points share one back half (owner_windows: the anchor walk,
// the diagonal-cache collapse, window generation, the per-owner sort):
// filter1_batch collects each owner's postings here (collect_owner) and
// applies the region test in the walk; filter1_survivors takes postings
// that the card already collected, sorted and region-filtered
// (csrc/filter1_front.cu), so both give the same windows.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <unordered_map>
#include <chrono>
#include <x86intrin.h>

// The call's time in two parts, for the caller's stage seconds: the k-mer
// keys and the CSR postings collection (lookup), timed by two TSC reads
// an owner, and the rest (sort, anchor walk and collapse, window
// generation); both scaled to the call's CLOCK_MONOTONIC duration
// (std::chrono::steady_clock) and written to ns_out[0], ns_out[1].
static inline int64_t mono_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

extern "C" {

struct SeedSpec {
    int32_t span;
    int32_t weight;
    int32_t n_offsets;
    int32_t off_is_32;            // csr_offsets dtype: 1=uint32, 0=int64
    const int32_t* offsets;       // included positions within the kmer
    const void* csr_offsets;      // [4^weight + 1] (uint32 or int64)
    const uint32_t* csr_positions;
};

// CSR offset load, dtype-branched (uint32 tables halve the random-read
// footprint: 4^12 entries x 3 seeds = 201MB vs 402MB, mostly L3-resident
// on hosts with big LLCs; the branch predicts perfectly)
static inline int64_t csr_at(const SeedSpec& S, uint32_t k) {
    return S.off_is_32 ? (int64_t)((const uint32_t*)S.csr_offsets)[k]
                       : ((const int64_t*)S.csr_offsets)[k];
}
static inline const void* csr_addr(const SeedSpec& S, uint32_t k) {
    return S.off_is_32 ? (const void*)((const uint32_t*)S.csr_offsets + k)
                       : (const void*)((const int64_t*)S.csr_offsets + k);
}

struct Filter1Params {
    int32_t n_seeds;
    int32_t read_len;
    int32_t window_len;
    int64_t cutoff;
    int32_t match_mode;
    double threshold;            // percent unless negative (absolute)
    int32_t match_score;
    int32_t b_gap_open;
    int32_t b_gap_extend;
    int32_t min_kmer_pos;
    int32_t use_region_counts;
    int32_t region_bits;
    int32_t region_overlap;
    int32_t collapse;
    int32_t gapless;
    int32_t search_fw;
    int32_t search_rv;
    int32_t hashed;
    int32_t max_seed_span;
    int64_t genome_total_len;
    int32_t n_contigs;
    const uint32_t* contig_offsets;
    const uint32_t* contig_lengths;
    // mate-pair region filter (read_get_mp_region_counts,
    // mapping.c:545-608): owners come in interleaved-pair groups of 4
    // (leg1 st0, leg1 st1, leg2 st0, leg2 st1); mp_drmin/mp_drmax are
    // per-owner region delta ranges (already sliced to this call's
    // owner range). mp_mode 0 disables.
    int32_t mp_mode;
    const int64_t* mp_drmin;
    const int64_t* mp_drmax;
};

// output buffers, caller-allocated with capacity `cap`; return count or -1
// if capacity exceeded (caller retries with a larger buffer)
struct Filter1Out {
    int64_t cap;
    int64_t* owner;
    int32_t* cn;
    int64_t* g_off;
    int32_t* w_len;
    int64_t* score_window_gen;
    int32_t* matches;
    int64_t* score_max;
    int64_t* ax;
    int64_t* ay;
    int64_t* alen;
    int64_t* awid;
};

struct Anchor {
    int64_t x;       // absolute genome position
    int32_t y;
    int32_t length;
    int32_t weight;
    int32_t cn;
};

static inline uint32_t mix_hash(uint32_t a) {
    // gmapper.h:309-319
    a = (a + 0x7ed55d16u) + (a << 12);
    a = (a ^ 0xc761c23cu) ^ (a >> 19);
    a = (a + 0x165667b1u) + (a << 5);
    a = (a + 0xd3a2646cu) ^ (a << 9);
    a = (a + 0xfd7046c5u) + (a << 3);
    a = (a ^ 0xb55a4f09u) ^ (a >> 16);
    return a;
}

static inline int contig_of(const Filter1Params* p, int64_t pos) {
    // binary search over contig_offsets
    int lo = 0, hi = p->n_contigs;
    while (lo + 1 < hi) {
        int mid = (lo + hi) / 2;
        if ((int64_t)p->contig_offsets[mid] <= pos) lo = mid;
        else hi = mid;
    }
    return lo;
}

// one (read, strand)'s worth of state, reused across calls
struct Scratch {
    std::vector<uint32_t> keys;              // kmer mapidx per (seed, pos)
    std::vector<Anchor> collapsed;
    // flat generation-tagged region map (region_map, gmapper.h:284-294):
    // value = (generation << 2) | marks(saturating at 2)
    std::vector<uint32_t> region_map;
    uint32_t region_gen = 0;
    std::vector<int32_t> cache;              // diagonal cache
    // cache-local copies of each slot's (diag, cn): the hit test runs
    // against L1-resident arrays instead of poking the (large,
    // effectively random) collapsed[] entry per survivor
    std::vector<int64_t> cache_diag;
    std::vector<int32_t> cache_cn;
    // packed (position << 32 | stream) keys for the sort-based merge
    std::vector<uint64_t> pos_keys;
    std::vector<uint64_t> radix_tmp;     // LSD radix double buffer
    struct ListRef { int64_t lo, hi; uint32_t sbase;
                     const uint32_t* plist; };
    std::vector<ListRef> lists;
    // mate-pair group state (4 owners of an interleaved read pair)
    std::vector<uint64_t> mp_pos_keys[4];
    std::vector<int64_t> mp_marks;
    std::vector<int64_t> mp_m1[4], mp_m2[4];
    std::vector<uint8_t> heavy;
};

// sorted-range existence query: any element in [lo, hi]?
static inline bool any_in(const std::vector<int64_t>& v, int64_t lo,
                          int64_t hi) {
    auto it = std::lower_bound(v.begin(), v.end(), lo);
    return it != v.end() && *it <= hi;
}

static inline bool contains(const std::vector<int64_t>& v, int64_t x) {
    auto it = std::lower_bound(v.begin(), v.end(), x);
    return it != v.end() && *it == x;
}

// Fast spaced-kmer extraction for unhashed seeds with span <= 32: the
// read is packed into a rolling 2-bit word and each key is one PEXT
// (BMI2 parallel bit extract) against the seed's doubled mask — the
// same (base << 2j) layout as kmer_key below, ~10x fewer ops.
// `mask2` = OR_j (3 << 2*offsets[j]) with offsets ascending.
static inline void keys_pext(const SeedSpec& S, uint64_t mask2,
                             const uint8_t* rc, int L, int min_pos,
                             uint32_t* out) {
    uint64_t w = 0;
    int lo = min_pos;
    int hi = L - S.span;             // last valid kmer start
    for (int i = L - 1; i >= lo; i--) {
        w = (w << 2) | (uint64_t)(rc[i] & 3);
        if (i <= hi)
            out[i] = (uint32_t)_pext_u64(w, mask2);
    }
}

static inline uint32_t kmer_key(const Filter1Params* p, const SeedSpec& S,
                                const uint8_t* rc, int i) {
    if (!p->hashed) {
        uint32_t key = 0;
        for (int j = 0; j < S.n_offsets; j++)
            key |= (uint32_t)(rc[i + S.offsets[j]] & 3) << (2 * j);
        return key;
    }
    uint32_t key = 0;
    int n_words = (p->max_seed_span + 7) / 8;
    for (int w = 0; w < n_words; w++) {
        uint32_t word = 0;
        for (int f = 0; f < 8; f++) {
            int j = 8 * w + f;
            if (j >= S.span) continue;
            int pos = S.span - 1 - j;
            bool inc = false;
            for (int q = 0; q < S.n_offsets; q++)
                if (S.offsets[q] == pos) { inc = true; break; }
            if (!inc) continue;
            word |= (uint32_t)rc[i + pos] << (4 * f);
        }
        key = mix_hash(word ^ key);
    }
    return key & ((1u << 24) - 1);
}

}  // extern "C"

// One call's state beside the thread's Scratch: the parameters, the PEXT
// masks of the fast key path and the lookup's TSC count.
struct Call {
    const Filter1Params* p;
    const SeedSpec* seeds;
    int L;
    int max_kmers;
    int64_t region_mask;
    int64_t n_regions;
    std::vector<uint64_t> pext_mask;
    uint64_t lookup_tsc = 0;
};

// Set up a call; -2 where the shape is unsupported.
static int64_t begin_call(Call& c, const Filter1Params* p,
                          const SeedSpec* seeds, Scratch& sc) {
    c.p = p;
    c.seeds = seeds;
    const int L = c.L = p->read_len;
    if ((int64_t)p->n_seeds * L >= (1 << 20))
        return -2;   // stream id would overflow the packed key (caller
                     // falls back to the numpy pipeline)
    c.region_mask = ((int64_t)1 << p->region_bits) - 1;
    const int64_t n_regions = c.n_regions =
        (p->genome_total_len >> p->region_bits) + 2;
    if (p->use_region_counts
        && (int64_t)sc.region_map.size() < n_regions) {
        sc.region_map.assign((size_t)n_regions, 0u);
        sc.region_gen = 0;
    }
    // per-owner kmer key cache: [seed][kmer index]
    int max_kmers = c.max_kmers = L;
    sc.keys.resize((size_t)p->n_seeds * max_kmers);

    // PEXT masks for the fast key path (unhashed, span<=32, ascending
    // offsets); 0 disables per seed
    std::vector<uint64_t>& pext_mask = c.pext_mask;
    pext_mask.assign(p->n_seeds, 0);
    if (!p->hashed) {
        for (int sn = 0; sn < p->n_seeds; sn++) {
            const SeedSpec& S = seeds[sn];
            if (S.span > 32) continue;
            bool asc = true;
            uint64_t m2 = 0;
            for (int j = 0; j < S.n_offsets; j++) {
                if (j && S.offsets[j] <= S.offsets[j - 1]) { asc = false;
                                                             break; }
                m2 |= (uint64_t)3 << (2 * S.offsets[j]);
            }
            if (asc) pext_mask[sn] = m2;
        }
    }
    return 0;
}

// The next owner's generation of the region map.
static void next_region_gen(Scratch& sc) {
    sc.region_gen++;
    if (sc.region_gen >= (1u << 29)) {  // wrap: clear, restart
        std::fill(sc.region_map.begin(), sc.region_map.end(), 0u);
        sc.region_gen = 1;
    }
}

// ---- single CSR walk: region marks (read_get_region_counts,
// mapping.c:459-542) fused with (position, stream) collection; the
// k-way heap merge of the reference (mapping.c:912-989) is replaced
// by one sort of packed (pos << 32 | stream) keys, which yields the
// identical (x, stream) visit order with far better cache behavior
// on long posting lists. With marks_out set (mate-pair groups),
// region touches go to a sortable vector instead of the
// generation-tagged map.
static void collect_owner(Call& c, Scratch& sc, const uint8_t* rc,
                          std::vector<uint64_t>& pos_out,
                          std::vector<int64_t>* marks_out) {
    const Filter1Params* p = c.p;
    const SeedSpec* seeds = c.seeds;
    const int L = c.L;
    const int max_kmers = c.max_kmers;
    const int64_t region_mask = c.region_mask;
    const uint64_t tsc_owner = __rdtsc();
    {
        for (int sn = 0; sn < p->n_seeds; sn++) {
            const SeedSpec& S = seeds[sn];
            if (c.pext_mask[sn]) {
                keys_pext(S, c.pext_mask[sn], rc, L, p->min_kmer_pos,
                          &sc.keys[(size_t)sn * max_kmers]);
                continue;
            }
            for (int i = p->min_kmer_pos; i + S.span <= L; i++)
                sc.keys[(size_t)sn * max_kmers + i] =
                    kmer_key(p, S, rc, i);
        }
    }
    const uint32_t gen_tag = sc.region_gen << 2;
    pos_out.clear();
    // prefetch every kmer's CSR offset row before the walk (the
    // reference's _mm_prefetch in the index walk, mapping.c:501-505)
    for (int sn = 0; sn < p->n_seeds; sn++) {
        const SeedSpec& S = seeds[sn];
        for (int i = p->min_kmer_pos; i + S.span <= L; i++)
            __builtin_prefetch(
                csr_addr(S, sc.keys[(size_t)sn * max_kmers + i]));
    }
    sc.lists.clear();
    for (int sn = 0; sn < p->n_seeds; sn++) {
        const SeedSpec& S = seeds[sn];
        for (int i = p->min_kmer_pos; i + S.span <= L; i++) {
            uint32_t key = sc.keys[(size_t)sn * max_kmers + i];
            int64_t lo = csr_at(S, key);
            int64_t hi = csr_at(S, key + 1);
            if (hi - lo > p->cutoff || lo >= hi) continue;
            __builtin_prefetch(&S.csr_positions[lo]);
            sc.lists.push_back({lo, hi, (uint32_t)(sn * L + i),
                                S.csr_positions});
        }
    }
    // bulk-write the packed keys: total size is known up front, so
    // one resize + raw-pointer stores replace per-element
    // push_back capacity checks (the long posting lists of dense
    // genomes stream through here). Keys pack as pos << 32 |
    // stream: the radix sort below orders on the pos word only
    // (stable, so equal-pos entries keep stream-ascending
    // insertion order — identical to the full (pos, stream) sort).
    int64_t total_pos = 0;
    for (auto& LRc : sc.lists) total_pos += LRc.hi - LRc.lo;
    pos_out.resize((size_t)total_pos);
    uint64_t* po = pos_out.data();
    size_t pn_out = 0;
    // posting lists are position-ascending (index/build.py:6-8), so
    // region ids form runs; once a region's mark count saturates at
    // 2 the update is idempotent and the run can skip the map
    // access entirely (the satellite-array tail lists of dense
    // genomes spend most of their postings inside one region)
    int64_t run_r = -1;
    bool run_done = false;
    for (size_t li = 0; li < sc.lists.size(); li++) {
        if (li + 1 < sc.lists.size())
            __builtin_prefetch(
                &sc.lists[li + 1].plist[sc.lists[li + 1].lo]);
        const Scratch::ListRef& LR = sc.lists[li];
        const int64_t lo = LR.lo, hi = LR.hi;
        const uint32_t* plist = LR.plist;
        const uint64_t sbase = LR.sbase;
        if (marks_out) {
            for (int64_t k = lo; k < hi; k++) {
                int64_t pos = (int64_t)plist[k];
                int64_t r = pos >> p->region_bits;
                marks_out->push_back(r);
                if ((pos & region_mask) < p->region_overlap && r > 0)
                    marks_out->push_back(r - 1);
                po[pn_out++] = ((uint64_t)pos << 32) | sbase;
            }
        } else if (p->use_region_counts) {
            for (int64_t k = lo; k < hi; k++) {
                if (k + 24 < hi) {
                    __builtin_prefetch(&plist[k + 24]);
                    // the region-map line too: the posting value 8
                    // ahead is already cache-resident from the
                    // stream prefetch above
                    if (k + 8 < hi)
                        __builtin_prefetch(&sc.region_map[
                            (size_t)(plist[k + 8]
                                     >> p->region_bits)]);
                }
                int64_t pos = (int64_t)plist[k];
                int64_t r = pos >> p->region_bits;
                if (r != run_r || !run_done) {
                    uint32_t v = sc.region_map[(size_t)r];
                    uint32_t m = ((v >> 2) == sc.region_gen)
                        ? ((v & 3) < 2 ? (v & 3) + 1 : 2) : 1;
                    sc.region_map[(size_t)r] = gen_tag | m;
                    run_r = r;
                    run_done = m >= 2;
                }
                if ((pos & region_mask) < p->region_overlap
                    && r > 0) {
                    uint32_t v2 = sc.region_map[(size_t)(r - 1)];
                    uint32_t m2 = ((v2 >> 2) == sc.region_gen)
                        ? ((v2 & 3) < 2 ? (v2 & 3) + 1 : 2) : 1;
                    sc.region_map[(size_t)(r - 1)] = gen_tag | m2;
                }
                po[pn_out++] = ((uint64_t)pos << 32) | sbase;
            }
        } else {
            for (int64_t k = lo; k < hi; k++)
                po[pn_out++] = ((uint64_t)plist[k] << 32) | sbase;
        }
    }
    c.lookup_tsc += __rdtsc() - tsc_owner;
    // tiny lists (the common case: ~2 positions per kmer hit)
    // sort ~2x faster by insertion than via introsort's dispatch;
    // medium/large lists (dense genomes: hundreds-thousands of
    // positions per owner) use a byte-LSD radix with constant-byte
    // pass skipping — keys are unique (pos << 20 | stream), so any
    // total sort is equivalent to std::sort, at ~6n moves instead
    // of n log n branchy compares
    size_t pn = pos_out.size();
    if (pn <= 48) {
        for (size_t a = 1; a < pn; a++) {
            uint64_t v = pos_out[a];
            size_t b = a;
            while (b > 0 && pos_out[b - 1] > v) {
                pos_out[b] = pos_out[b - 1];
                b--;
            }
            pos_out[b] = v;
        }
    } else {
        // LSD radix on the POS word only (keys are pos << 32 |
        // stream; stability keeps stream-ascending insertion order
        // for equal pos, so the result equals the full (pos,
        // stream) sort at ~half the passes): 11+11+10-bit digits,
        // 8KB count arrays, uniform digits skipped (genomes under
        // 2^22 never see the top pass)
        sc.radix_tmp.resize(pn);
        uint64_t* src = pos_out.data();
        uint64_t* dst = sc.radix_tmp.data();
        uint64_t all_or = 0;
        for (size_t a = 0; a < pn; a++) all_or |= src[a];
        const uint64_t pos_or = all_or >> 32;
        static const int shifts[3] = {32, 43, 54};
        static const uint32_t dmask[3] = {2047, 2047, 1023};
        uint32_t cnt[2048];
        for (int pass = 0; pass < 3; pass++) {
            if (pass && !(pos_or >> (shifts[pass] - 32)))
                break;       // no key has bits this high
            const int sh = shifts[pass];
            const uint32_t dm = dmask[pass];
            memset(cnt, 0, (dm + 1) * sizeof(uint32_t));
            for (size_t a = 0; a < pn; a++)
                cnt[(src[a] >> sh) & dm]++;
            bool uniform = false;
            for (uint32_t c = 0; c <= dm; c++)
                if (cnt[c] == pn) { uniform = true; break; }
                else if (cnt[c]) break;
            if (uniform) continue;
            uint32_t run = 0;
            for (uint32_t c = 0; c <= dm; c++) {
                uint32_t t = cnt[c];
                cnt[c] = run;
                run += t;
            }
            for (size_t a = 0; a < pn; a++)
                dst[cnt[(src[a] >> sh) & dm]++] = src[a];
            std::swap(src, dst);
        }
        if (src != pos_out.data())
            memcpy(pos_out.data(), src, pn * sizeof(uint64_t));
    }
}

// The walk's region test for one owner (read_get_region_counts'
// verdict, mapping.c:459-542): the posting's region has 2 or more
// marks, or it lies in the overlap and the region before has. Postings
// stream in pos-ascending order, so the verdict caches per RUN (one
// map load per region change, not per posting — the dense-genome walk
// is dominated by long same-region runs).
struct RegionKeep {
    const Call& c;
    const Scratch& sc;
    const uint32_t want_gen;
    int64_t wr_r = -2;
    bool wr_ok = false, wr_okm1 = false;
    bool operator()(int64_t x) {
        const Filter1Params* p = c.p;
        int64_t r = x >> p->region_bits;
        if (r != wr_r) {
            uint32_t v = sc.region_map[(size_t)r];
            wr_ok = (v >> 2) == want_gen && (v & 3) >= 2;
            if (r > 0) {
                uint32_t v2 = sc.region_map[(size_t)(r - 1)];
                wr_okm1 = (v2 >> 2) == want_gen
                          && (v2 & 3) >= 2;
            } else {
                wr_okm1 = false;
            }
            wr_r = r;
        }
        return wr_ok
            || ((x & c.region_mask) < p->region_overlap
                && wr_okm1);
    }
};

static bool keep_all(int64_t) { return true; }

// The back half of filter 1 for owner `ow`: the anchor walk over its
// sorted postings `keys[0, n)` that pass `keep` (contig tracking and the
// diagonal-cache collapse), the mate-pair heavy anchors (`heavy`, match
// mode 3 with mp_mode only), window generation and the per-owner
// (cn, g_off) insertion sort. Returns the new output count, or -1 when
// the output is full.
template <class Keep, class Heavy>
static int64_t owner_windows(Call& c, Scratch& sc, int64_t ow,
                             const uint64_t* keys, size_t n_keys,
                             Keep&& keep, Heavy&& heavy, Filter1Out* out,
                             int64_t out_n) {
    const Filter1Params* p = c.p;
    const SeedSpec* seeds = c.seeds;
    const int L = c.L;
    const int64_t region_mask = c.region_mask;
    sc.collapsed.clear();
    sc.cache.assign((size_t)L, -1);
    sc.cache_diag.assign((size_t)L, INT64_MIN);
    sc.cache_cn.assign((size_t)L, -1);
    {
    // contig c spans [contig_offsets[c], contig_offsets[c+1]) in
    // the binary search's "last offset <= pos" semantics; postings
    // stream in pos-ascending order, so the contig caches per run
    int cur_cn = 0;
    int64_t cn_end = p->n_contigs > 1
        ? (int64_t)p->contig_offsets[1] : INT64_MAX;
    for (size_t kk = 0; kk < n_keys; kk++) {
        const uint64_t pk = keys[kk];
        int64_t x = (int64_t)(pk >> 32);
        int32_t stream = (int32_t)(pk & 0xFFFFFFFFu);
        int32_t y = stream % L;
        int32_t span = seeds[stream / L].span;

        // region filter
        if (!keep(x)) continue;

        if (x >= cn_end)
            while (true) {
                cur_cn++;
                if (cur_cn >= p->n_contigs - 1) {
                    cur_cn = p->n_contigs - 1;
                    cn_end = INT64_MAX;
                    break;
                }
                cn_end = (int64_t)p->contig_offsets[cur_cn + 1];
                if (x < cn_end) break;
            }
        // collapse (anchor_uw_join via diagonal cache); the slot's
        // (diag, cn) live in cache-local arrays so the common
        // no-merge case never touches collapsed[]
        if (p->collapse) {
            int64_t diag = x - y;
            int32_t ck = (int32_t)((x + L - y) % L);
            int32_t j = sc.cache[ck];
            if (j >= 0 && sc.cache_diag[ck] == diag
                && sc.cache_cn[ck] == cur_cn) {
                Anchor& a = sc.collapsed[(size_t)j];
                if (x + span > a.x + a.length)
                    a.length = (int32_t)(x - a.x + span);
                a.weight += 1;
                continue;
            }
            Anchor a;
            a.x = x; a.y = y; a.length = span; a.weight = 1;
            a.cn = cur_cn;
            sc.collapsed.push_back(a);
            sc.cache[ck] = (int32_t)(sc.collapsed.size() - 1);
            sc.cache_diag[ck] = diag;
            sc.cache_cn[ck] = cur_cn;
        } else {
            Anchor a;
            a.x = x; a.y = y; a.length = span; a.weight = 1;
            a.cn = cur_cn;
            sc.collapsed.push_back(a);
        }
    }
    }

    // per-anchor mate support for match mode 3 (heavy_mp,
    // mapping.c:1083-1094): the mate's opposite strand has a
    // >=2-touch region within the anchor region's delta range
    sc.heavy.clear();
    if (p->match_mode == 3 && p->mp_mode) {
        sc.heavy.resize(sc.collapsed.size(), 0);
        for (size_t hh = 0; hh < sc.collapsed.size(); hh++) {
            int64_t hx = sc.collapsed[hh].x;
            int64_t hr = hx >> p->region_bits;
            bool hv = heavy(hr);
            if (!hv && (hx & region_mask) < p->region_overlap
                && hr > 0)
                hv = heavy(hr - 1);
            sc.heavy[hh] = hv ? 1 : 0;
        }
    }

    // ---- window generation (read_get_hit_list, mapping.c:1025-1229)
    const std::vector<Anchor>& A = sc.collapsed;
    int64_t n = (int64_t)A.size();
    int64_t first_out = out_n;
    for (int64_t i = 0; i < n; i++) {
        const Anchor& ai = A[i];
        int cn = ai.cn;
        int64_t coff = (int64_t)p->contig_offsets[cn];
        int64_t clen = (int64_t)p->contig_lengths[cn];
        int64_t w_len = p->window_len;
        if (w_len > clen) w_len = clen;
        int64_t gend = (ai.x - coff) + L - 1 - ai.y;
        if (gend > clen - 1) gend = clen - 1;
        int64_t gstart = gend >= p->window_len ? gend - p->window_len
                                               : 0;
        int64_t max_idx = i;
        int64_t max_score = (int64_t)ai.length * p->match_score;
        const bool hv = !sc.heavy.empty() && sc.heavy[(size_t)i];
        if (!p->gapless && ai.weight == 1
            && (p->match_mode == 2
                || (p->match_mode == 3 && !hv)))
            max_score = -1;
        if (!p->gapless) {
            for (int64_t j = i - 1;
                 j >= 0 && A[j].x >= coff + gstart; j--) {
                if (A[j].y >= ai.y) continue;
                int64_t dx = ai.x - A[j].x;
                int64_t dy = ai.y - A[j].y;
                int64_t short_len, long_len;
                if (dx > dy) { short_len = dy + ai.length;
                               long_len = dx + ai.length; }
                else { short_len = dx + ai.length;
                       long_len = dy + ai.length; }
                int64_t tmp = short_len * p->match_score;
                if (long_len > short_len)
                    tmp += p->b_gap_open
                         + (long_len - short_len) * p->b_gap_extend;
                if (tmp > max_score) { max_score = tmp; max_idx = j; }
            }
        }
        int64_t cap = (L < w_len ? L : w_len) * p->match_score;
        bool keep;
        if (p->gapless || p->match_mode == 1) keep = true;
        else {
            // the reference truncates the percent threshold to
            // int before comparing (mapping.c:1157: `max_score >=
            // (int)abs_or_pct(...)`) — without the trunc,
            // 400 * 0.55 = 220.0000000000000028 rejects a window
            // the reference keeps at exactly 220
            int64_t thr = p->threshold < 0
                ? (int64_t)(-p->threshold)
                : (int64_t)((double)cap * (p->threshold / 100.0));
            keep = max_score >= thr;
            // heavy anchors get a window with no threshold check
            // (mapping.c:1160-1163)
            if (p->match_mode == 3 && hv) keep = true;
        }
        if (!keep) continue;

        const Anchor& aj = A[(size_t)max_idx];
        int64_t x_len = (ai.x - aj.x) + ai.length;
        int64_t goff;
        if ((p->window_len - x_len) / 2 < aj.x - coff)
            goff = (aj.x - coff) - (p->window_len - x_len) / 2;
        else goff = 0;
        if (goff + w_len > clen) goff = clen - w_len;

        int64_t rel_xi = ai.x - (coff + goff);
        int64_t rel_xj = aj.x - (coff + goff);
        int64_t jx, jy, jl, jw, jmatches;
        if (max_idx == i) {
            jx = rel_xi; jy = ai.y; jl = ai.length; jw = 1;
            jmatches = ai.weight;
        } else {
            // anchor_join of two width-1 anchors (anchors.c:10-54)
            int64_t nw0 = rel_xi + ai.y, sw0 = rel_xi - ai.y;
            int64_t se0 = nw0 + 2 * ((int64_t)ai.length - 1);
            int64_t nw1 = rel_xj + aj.y, sw1 = rel_xj - aj.y;
            int64_t se1 = nw1 + 2 * ((int64_t)aj.length - 1);
            int64_t nwm = nw0 < nw1 ? nw0 : nw1;
            int64_t swm = sw0 < sw1 ? sw0 : sw1;
            int64_t nem = sw0 > sw1 ? sw0 : sw1;
            int64_t sem = se0 > se1 ? se0 : se1;
            if (((nwm + swm) % 2 + 2) % 2 != 0) nwm--;
            jx = (nwm + swm) / 2;
            if ((nwm + swm) < 0 && (nwm + swm) % 2 != 0) jx--; // floor
            jy = nwm - jx;
            if (((nem - swm) % 2 + 2) % 2 != 0) nem++;
            jw = (nem - swm) / 2 + 1;
            if (((sem - nwm) % 2 + 2) % 2 != 0) sem++;
            jl = (sem - nwm) / 2 + 1;
            jmatches = (int64_t)ai.weight + aj.weight;
        }
        int64_t m = p->gapless || max_idx == i
            ? ai.weight : (int64_t)ai.weight + aj.weight;

        if (out_n >= out->cap) return -1;
        out->owner[out_n] = ow;
        out->cn[out_n] = cn;
        out->g_off[out_n] = goff;
        out->w_len[out_n] = (int32_t)w_len;
        out->score_window_gen[out_n] = max_score;
        out->matches[out_n] = (int32_t)m;
        out->score_max[out_n] = cap;
        out->ax[out_n] = jx;
        out->ay[out_n] = jy;
        out->alen[out_n] = jl;
        out->awid[out_n] = jw;
        out_n++;
    }
    // stable insertion sort by (cn, g_off) within this owner
    for (int64_t i2 = first_out + 1; i2 < out_n; i2++) {
        int64_t j2 = i2;
        while (j2 > first_out
               && out->cn[j2 - 1] == out->cn[i2]
               && out->g_off[j2 - 1] > out->g_off[i2])
            j2--;
        if (j2 < i2) {
            // rotate element i2 into place j2
            int64_t t_owner = out->owner[i2];
            int32_t t_cn = out->cn[i2];
            int64_t t_goff = out->g_off[i2];
            int32_t t_wlen = out->w_len[i2];
            int64_t t_swg = out->score_window_gen[i2];
            int32_t t_m = out->matches[i2];
            int64_t t_cap = out->score_max[i2];
            int64_t t_ax = out->ax[i2], t_ay = out->ay[i2];
            int64_t t_al = out->alen[i2], t_aw = out->awid[i2];
            for (int64_t k2 = i2 - 1; k2 >= j2; k2--) {
                out->owner[k2 + 1] = out->owner[k2];
                out->cn[k2 + 1] = out->cn[k2];
                out->g_off[k2 + 1] = out->g_off[k2];
                out->w_len[k2 + 1] = out->w_len[k2];
                out->score_window_gen[k2 + 1] =
                    out->score_window_gen[k2];
                out->matches[k2 + 1] = out->matches[k2];
                out->score_max[k2 + 1] = out->score_max[k2];
                out->ax[k2 + 1] = out->ax[k2];
                out->ay[k2 + 1] = out->ay[k2];
                out->alen[k2 + 1] = out->alen[k2];
                out->awid[k2 + 1] = out->awid[k2];
            }
            out->owner[j2] = t_owner;
            out->cn[j2] = t_cn;
            out->g_off[j2] = t_goff;
            out->w_len[j2] = t_wlen;
            out->score_window_gen[j2] = t_swg;
            out->matches[j2] = t_m;
            out->score_max[j2] = t_cap;
            out->ax[j2] = t_ax;
            out->ay[j2] = t_ay;
            out->alen[j2] = t_al;
            out->awid[j2] = t_aw;
        }
    }
    return out_n;
}

// The call's time in its two parts (lookup, the rest), as ns_out.
static void split_time(const Call& c, int64_t ns0, uint64_t tsc0,
                       int64_t* ns_out) {
    const int64_t ns = mono_ns() - ns0;
    const uint64_t tsc = __rdtsc() - tsc0;
    ns_out[0] = tsc ? (int64_t)((double)ns * c.lookup_tsc / tsc) : 0;
    ns_out[0] = ns_out[0] < ns ? ns_out[0] : ns;
    ns_out[1] = ns - ns_out[0];
}

extern "C" {

int64_t filter1_batch(
    const Filter1Params* p,
    const SeedSpec* seeds,
    const uint8_t* codes,        // [n_owners, read_len] row-major
    int64_t n_owners,
    Filter1Out* out,
    int64_t* ns_out,             // [2]: lookup, the rest (success only)
    int64_t* seg_start)          // [n_owners + 1]
{
    const int64_t ns0 = mono_ns();
    const uint64_t tsc0 = __rdtsc();
    static thread_local Scratch sc;
    Call c;
    int64_t out_n = begin_call(c, p, seeds, sc);
    if (out_n) return out_n;
    const int L = c.L;
    const int64_t region_mask = c.region_mask;
    const int64_t n_regions = c.n_regions;
    if (p->mp_mode && ((n_owners % 4) || !p->use_region_counts))
        return -2;   // mp filter needs interleaved pair groups + regions
    for (int64_t ow = 0; ow < n_owners; ow++) {
        seg_start[ow] = out_n;
        int st = (int)(ow & 1);
        const uint8_t* rc = codes + ow * L;
        const int q = (int)(ow & 3);
        // mate owner of (read i, st) is (i^1, 1-st): 0<->3, 1<->2
        // within the 4-owner group
        const int mate_q = 3 - q;
        if (p->mp_mode && q == 0) {
            // phase A for the group: collect all four owners' positions
            // and region marks, then sort marks into >=1 / >=2 id sets
            // (read_get_mp_region_counts, mapping.c:545-608)
            for (int g = 0; g < 4; g++) {
                sc.mp_marks.clear();
                collect_owner(c, sc, codes + (ow + g) * L,
                              sc.mp_pos_keys[g], &sc.mp_marks);
                std::sort(sc.mp_marks.begin(), sc.mp_marks.end());
                sc.mp_m1[g].clear();
                sc.mp_m2[g].clear();
                size_t i2 = 0;
                while (i2 < sc.mp_marks.size()) {
                    size_t j2 = i2;
                    while (j2 + 1 < sc.mp_marks.size()
                           && sc.mp_marks[j2 + 1] == sc.mp_marks[i2])
                        j2++;
                    sc.mp_m1[g].push_back(sc.mp_marks[i2]);
                    if (j2 > i2)
                        sc.mp_m2[g].push_back(sc.mp_marks[i2]);
                    i2 = j2 + 1;
                }
            }
        }
        if ((st == 0 && !p->search_fw) || (st == 1 && !p->search_rv))
            continue;
        if (p->mp_mode) {
            const std::vector<int64_t>* own_m2 = &sc.mp_m2[q];
            const std::vector<int64_t>* mate_m1 = &sc.mp_m1[mate_q];
            const std::vector<int64_t>* mate_m2 = &sc.mp_m2[mate_q];
            int64_t drmin = p->mp_drmin[ow];
            int64_t drmax = p->mp_drmax[ow];
            sc.pos_keys.swap(sc.mp_pos_keys[q]);

            // per-anchor-region mate support: modes combine the read's
            // own >=2 marks with the mate window's marks
            // (advance_index_in_genomemap, mapping.c:695-745)
            auto mp_pass = [&](int64_t rq) -> bool {
                bool main2 = contains(*own_m2, rq);
                int64_t lo_q = rq + drmin < 0 ? 0 : rq + drmin;
                int64_t hi_q = rq + drmax > n_regions - 1
                    ? n_regions - 1 : rq + drmax;
                bool mp2 = any_in(*mate_m2, lo_q, hi_q);
                if (p->mp_mode == 1) return main2 && mp2;
                if (p->mp_mode == 2) return main2 || mp2;
                return any_in(*mate_m1, lo_q, hi_q) && (main2 || mp2);
            };
            auto mp2_near = [&](int64_t rq) -> bool {
                int64_t lo_q = rq + drmin < 0 ? 0 : rq + drmin;
                int64_t hi_q = rq + drmax > n_regions - 1
                    ? n_regions - 1 : rq + drmax;
                return any_in(*mate_m2, lo_q, hi_q);
            };
            auto mp_keep = [&](int64_t x) -> bool {
                int64_t r = x >> p->region_bits;
                bool ok = mp_pass(r);
                if (!ok && (x & region_mask) < p->region_overlap && r > 0)
                    ok = mp_pass(r - 1);
                return ok;
            };
            out_n = owner_windows(c, sc, ow, sc.pos_keys.data(),
                                  sc.pos_keys.size(), mp_keep, mp2_near,
                                  out, out_n);
        } else if (p->use_region_counts) {
            next_region_gen(sc);
            collect_owner(c, sc, rc, sc.pos_keys, nullptr);
            out_n = owner_windows(c, sc, ow, sc.pos_keys.data(),
                                  sc.pos_keys.size(),
                                  RegionKeep{c, sc, sc.region_gen},
                                  keep_all, out, out_n);
        } else {
            collect_owner(c, sc, rc, sc.pos_keys, nullptr);
            out_n = owner_windows(c, sc, ow, sc.pos_keys.data(),
                                  sc.pos_keys.size(), keep_all, keep_all,
                                  out, out_n);
        }
        if (out_n < 0) return -1;
    }
    seg_start[n_owners] = out_n;
    split_time(c, ns0, tsc0, ns_out);
    return out_n;
}

// Filter 1 from postings already collected, sorted and region-filtered
// elsewhere (the device's front half, core/filter1_front.py): owner ow's
// surviving packed keys are surv[surv_base[ow], + surv_count[ow]), the
// subsequence of filter1_batch's sorted pos_keys that passes the walk's
// region test, in the same order. An owner with surv_count < 0 (over
// the front half's capacity) runs filter1_batch's own front half here.
// The back half is owner_windows, as in filter1_batch, so the FlatHits
// are filter1_batch's, array for array. No mate-pair mode (-2).
int64_t filter1_survivors(
    const Filter1Params* p,
    const SeedSpec* seeds,
    const uint8_t* codes,        // [n_owners, read_len] row-major
    int64_t n_owners,
    const uint64_t* surv,
    const int64_t* surv_base,    // [n_owners]
    const int64_t* surv_count,   // [n_owners]; < 0: the host collects
    Filter1Out* out,
    int64_t* ns_out,             // [2]: host lookup, the rest
    int64_t* seg_start)          // [n_owners + 1]
{
    const int64_t ns0 = mono_ns();
    const uint64_t tsc0 = __rdtsc();
    static thread_local Scratch sc;
    Call c;
    int64_t out_n = begin_call(c, p, seeds, sc);
    if (out_n) return out_n;
    if (p->mp_mode) return -2;
    for (int64_t ow = 0; ow < n_owners; ow++) {
        seg_start[ow] = out_n;
        int st = (int)(ow & 1);
        if ((st == 0 && !p->search_fw) || (st == 1 && !p->search_rv))
            continue;
        if (surv_count[ow] >= 0) {
            out_n = owner_windows(c, sc, ow, surv + surv_base[ow],
                                  (size_t)surv_count[ow], keep_all,
                                  keep_all, out, out_n);
        } else if (p->use_region_counts) {
            next_region_gen(sc);
            collect_owner(c, sc, codes + ow * c.L, sc.pos_keys, nullptr);
            out_n = owner_windows(c, sc, ow, sc.pos_keys.data(),
                                  sc.pos_keys.size(),
                                  RegionKeep{c, sc, sc.region_gen},
                                  keep_all, out, out_n);
        } else {
            collect_owner(c, sc, codes + ow * c.L, sc.pos_keys, nullptr);
            out_n = owner_windows(c, sc, ow, sc.pos_keys.data(),
                                  sc.pos_keys.size(), keep_all, keep_all,
                                  out, out_n);
        }
        if (out_n < 0) return -1;
    }
    seg_start[n_owners] = out_n;
    split_time(c, ns0, tsc0, ns_out);
    return out_n;
}

}  // extern "C"
