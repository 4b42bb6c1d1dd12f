// Native paired-end post-device pipeline: pair-up, paired pass1/pass2,
// half-paired fallback, paired MQV and SAM rendering over flat arrays.
//
// Mirrors, bit-for-bit, the Python generic path (shrimp_tpu/paired.py),
// which itself mirrors the reference:
//   readpair_pair_up_hits        mapping.c:266-325
//   read_pass1(_per_strand)      mapping.c:1261-1366 (walk semantics)
//   readpair_get_vector_hits     mapping.c:1877-1932
//   readpair_pass2               mapping.c:2181-2314
//   readpair_remove_duplicate_*  mapping.c:2084-2175
//   handle_readpair hp fallback  mapping.c:2607-2611
//   compute_paired_mqv           output.c:811-942
//   hit_output (paired fields)   output.c:227-774
//
// The device side has already produced, speculatively for EVERY
// candidate window, the vector-SW score and the full-SW alignment
// (packed + 2-bit op string); this code only selects, scores and
// renders -- no DP here.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <unordered_map>

#include "cs_eval.h"

extern "C" {

struct PPParams {
  int64_t n_pairs;
  int64_t n_windows;
  int32_t read_len;
  int32_t window_len;
  int32_t ops_words;
  // pairing deltas for leg0 strands 0/1 (readpair_compute_mp_ranges)
  int64_t d_min[2];
  int64_t d_max[2];
  // paired pass1 leg walk (only_paired=1)
  int32_t p1_min_matches;
  int32_t p1_overlap;          // absolute
  double p1_threshold;         // leg vector threshold (%/abs by sign)
  // pair-level pass1 heap
  int32_t pair1_num_outputs;
  double pair1_threshold;
  // per-foot full-SW vector gate (read pass2 thr = sw_full * 0.5)
  double foot_threshold;
  // paired pass2
  double pair2_threshold;
  int32_t pair2_num_outputs;
  int32_t strata;
  int32_t max_alignments;
  // half-paired fallback
  int32_t hp_enabled;
  int32_t hp_min_matches;
  int32_t hp_overlap;
  double hp_threshold;         // vector threshold
  int32_t hp_num_tmp;
  double hp_full_threshold;
  int32_t hp_num_outputs;
  // MQV / scoring constants
  int32_t compute_mqv;
  double alpha, beta;          // LS posterior calibration
  int32_t match_score, mismatch_score;
  double total_genome_size;
  double ins_mean, ins_stddev;
  int32_t mode_sign_st0;       // 1 for opp-in/col-fw isize sign rule
  // blobs
  const uint32_t* contig_lengths;
  const int32_t* contig_name_off;
  const char* contig_names;
  const int64_t* name_off;     // per read (2 * n_pairs + 1)
  const char* names;
  const uint8_t* seq_fwd;      // [2B, R]
  const uint8_t* seq_rc;
  const uint8_t* qual_fwd;     // [2B, R] PHRED+33, or null -> '*'
  const uint8_t* qual_rc;      // reversed rows
  const uint8_t* qual_raw;     // [2B, R] original offset (unmapped recs
                               // print quals unrescaled, output.c:419)
  // ---- colour-space mode (cs=1): CS packed rows + step strings
  // replace the LS packed/ops; feet rescore through post-SW
  // (cs_eval.h) instead of the LS closed form
  int32_t cs;
  int32_t pr_random_den;       // |mm-m| (LS) or |crossover| (CS),
                               // mapping.h:39-60
  double pr_xover, pr_snp;
  double pr_del_open, pr_del_extend, pr_ins_open, pr_ins_extend;
  int32_t cs_fastq;            // emit QUAL/CQ from quals
  int32_t cs_use_read_qvs;
  int32_t cs_qual_delta;
  int32_t cs_use_sanger;
  const uint8_t* cs_genome_fwd;
  const uint8_t* cs_genome_rc;
  const uint8_t* cs_colours;   // [2B, R]
  const uint8_t* cs_qr_tab;    // [2B, 4, R]
  const int32_t* cs_initbp;    // [2B]
  const uint8_t* cs_readseq;   // [2B, cs_read_seq_len]
  int32_t cs_read_seq_len;
  const uint8_t* cs_quals;     // [2B, R] scoring quals or null
  const uint8_t* cs_cq;        // [2B, cs_cq_len] raw CQ chars or null
  int32_t cs_cq_len;
  // ---- sharded-index MQV recombination (MAPPING_QUALITIES Part 2c,
  // mergesam/sam_reader.c:417-520 as an on-device collective). Pass 1
  // (part_out set): per-(pair, shard) partial statistics are written,
  // columns [z1a, z1b, ins_denom, z3, best_post_a, z4a, best_post_b,
  // z4b, pr2_min]; additive columns psum across shards, pr2_min pmins,
  // z4 legs merge by argmax of best_post (first shard wins ties, the
  // whole-run first-max rule). Pass 2 (ext_in set): the merged values
  // [z1a, z1b, ins_denom, z3, z4a, z4b, pr2_pre] replace the local
  // sums in every class denominator and MQV. Null = single-shard.
  const int32_t* win_shard;    // [n_windows] global shard per window
  int32_t n_shards;
  double* part_out;            // [n_pairs, n_shards, 9]
  const double* ext_in;        // [n_pairs, 7]
  // ---- select-then-full two-phase (the reference's lazy full-SW: the
  // vector pass selects the feet, only those run full SW —
  // mapping.c:1261-1366 only_paired + the hp option set). select_only:
  // run pair-up + pass1 walks + the extraction heaps from the VECTOR
  // scores alone and append every row that could need full-SW results
  // to sel_out (paired heap feet + a superset of the hp heap: size
  // hp_num_tmp + pair2_num_outputs per leg, since at most
  // pair2_num_outputs saved rows are excluded in the render pass);
  // return the count. Render pass: full_valid[t]=0 marks rows whose
  // full results were not computed — pp_run_full on such a row sets
  // *rescue_flag (caller re-dispatches full SW for every row and
  // re-renders; correctness never depends on the superset argument).
  const uint8_t* full_valid;   // [n_windows] or null
  int32_t* rescue_flag;        // out: COUNT of missing-full rows hit
  int32_t select_only;
  int32_t* sel_out;            // [cap] selected rows (select mode) /
                               // missing rows (render mode rescue)
  // ---- renderer-level flags (must not evict the fast path)
  const char* rg;              // "\tRG:Z:<name>" suffix or null
  int32_t rg_len;
  int32_t all_contigs;         // omit Z fields
  int32_t sam_unaligned;       // emit flag-4 records for silent pairs
  int32_t sam_r2;              // append R2:Z (LS) / X2:Z (CS) mate seq
  const uint8_t* seq_raw;      // [2B, R] raw read chars (LS R2 +
                               // unaligned SEQ uses seq_fwd; R2 uses
                               // the RAW characters, output.c:758-766)
  int64_t una_lo, una_hi;      // unaligned emission pair range
                               // (read-sharded ranks restrict to slice)
  int64_t rescue_cap;          // capacity of sel_out in render mode
};

struct PPWin {
  const int64_t* seg;          // [4 * n_pairs + 1] owner row ranges
  const int32_t* cn;
  const int64_t* g_off;        // strand coords (pair_up algebra)
  const int64_t* g_off_norm;   // normalized (gen_st) coords
  const int8_t* gen_st;        // 0/1 after strand normalization
  const int32_t* w_len;
  const int32_t* matches;      // kmer matches
  const int64_t* score_max;
  const int64_t* vec;          // vector-SW scores
  const int32_t* packed;       // [n, 10] full-SW results (LS mode)
  const uint8_t* ops_pk;       // [n, ops_words]
  // CS mode replacements (packed/ops_pk unused)
  const int16_t* cs_packed;    // [n, 12]
  const int8_t* cs_steps;      // [n, cs_steps_words]
  const int64_t* start_abs;    // normalized absolute plane offsets
};

// ------------------------------------------------------------ helpers

static inline double pp_abs_or_pct(double t, double smax) {
  return t < 0 ? -t : t * smax / 100.0;
}

static inline int pp_qv_from_pr_corr(double pr_corr) {
  double pr_err = 1.0 - pr_corr;
  if (pr_err > .99999999) return 0;
  if (pr_err < 1e-25) return 250;
  return (int)(-10.0 * log(pr_err) / log(10.0));
}

static inline int pp_neglog(double x) {
  return (int)(1000.0 * -log(x));
}

// util.h:310-326
static double pp_normal_cdf(double x, double mean, double stddev) {
  double y = fabs((x - mean) / stddev);
  const double b0 = 0.2316419, b1 = 0.319381530, b2 = -0.356563782;
  const double b3 = 1.781477937, b4 = -1.821255978, b5 = 1.330274429;
  const double pi = 3.141592653589;
  double t = 1.0 / (1.0 + b0 * y);
  double res = (exp(-y * y / 2) / sqrt(2.0 * pi)) *
               ((((b5 * t + b4) * t + b3) * t + b2) * t + b1) * t;
  if (x > mean) res = 1 - res;
  return res;
}

static double pp_log_nchoosek(int64_t n, int64_t k) {
  double res = 0.0;
  for (int64_t i = 0; i < k; i++)
    res += log((double)(n - i)) - log((double)(i + 1));
  return res;
}

// mapping.h:39-60 (denominator |mm-m| for LS, |crossover| for CS)
static double pp_pr_random(const PPParams* p, int64_t score) {
  int64_t L = p->read_len;
  int64_t full = L * p->match_score;
  if (score > full) return 1e-200;
  int64_t n = 0;
  if (full != score) {
    int64_t num = full - score;
    if (num < 0) num = 0;
    int64_t den = p->pr_random_den;
    n = (num + den - 1) / den;   // ceil, matches -(-x // y)
  }
  double tmp = -pp_log_nchoosek(L, n) - (double)n * log(3.0)
               + (double)L * log(4.0);
  return exp(-tmp);
}

// colour-space foot evaluation state (post-SW results cached per
// window row; only pass1-selected feet ever run)
struct CSMode {
  cseval::Ctx ctx;
  cseval::Scratch sc;
  std::unordered_map<int32_t, cseval::Result> res;
};

// output.c:796-808
static inline double pp_pr_insert(const PPParams* p, double isz) {
  double res = pp_normal_cdf(isz + 10, p->ins_mean, p->ins_stddev)
             - pp_normal_cdf(isz - 10, p->ins_mean, p->ins_stddev);
  return res > 1e-200 ? res : 1e-200;
}

// bounded top-k min-heap in DEF_EXTHEAP array layout (heap.h:226-318)
struct PPHeapEnt {
  int64_t key;
  int32_t a, b;     // payload rows
};

static inline void pp_heap_insert(PPHeapEnt* h, int& load, PPHeapEnt e) {
  h[load++] = e;
  int node = load, par = node / 2;
  while (node > 1 && h[node - 1].key < h[par - 1].key) {
    std::swap(h[node - 1], h[par - 1]);
    node = par;
    par = node / 2;
  }
}

static inline void pp_heap_replace_min(PPHeapEnt* h, int load,
                                       PPHeapEnt e) {
  h[0] = e;
  int node = 1;
  for (;;) {
    int l = node * 2, r = node * 2 + 1, mn = node;
    if (l <= load && h[l - 1].key < h[mn - 1].key) mn = l;
    if (r <= load && h[r - 1].key < h[mn - 1].key) mn = r;
    if (mn == node) break;
    std::swap(h[mn - 1], h[node - 1]);
    node = mn;
  }
}

// --------------------------------------------------- per-window state

struct WinState {
  std::vector<int64_t> sv;        // score_vector (-1 = unset)
  std::vector<int64_t> pct_sv;
  std::vector<int64_t> pass2_key;
  std::vector<uint8_t> saved;
  std::vector<uint8_t> ran;       // full SW "has run" (sfrp != NULL)
  std::vector<int32_t> sf;        // score_full (posterior score)
  std::vector<double> post;       // posterior
  std::vector<int64_t> pct_sf;
};

// LS posterior closed form + vector gate (hit_run_full_sw
// mapping.c:380-398 + mapping.c:1609-1625); CS runs the full post-SW
// rescoring (hit_run_full_sw mapping.c:375-379 + sw-post.c) with the
// context's DP-score threshold (the kernel thresh of _pass2_cs)
static void pp_run_full(const PPParams* p, const PPWin* w, WinState& S,
                        int64_t t, double leg_thr, CSMode* csm,
                        int64_t ri) {
  if (S.ran[t]) return;
  S.ran[t] = 1;
  if (p->full_valid && !p->full_valid[t]) {
    // two-phase select missed this row: record it (sel_out doubles as
    // the rescue-row buffer in render mode) so the caller can fetch
    // full SW for just the missing rows and re-render
    if (p->rescue_flag) {
      int32_t k = (*p->rescue_flag)++;
      if (p->sel_out && k < p->rescue_cap) p->sel_out[k] = (int32_t)t;
    }
    S.sf[t] = 0;
    S.post[t] = 0.0;
    S.pct_sf[t] = 0;
    return;
  }
  if (p->cs) {
    const int16_t* pk = w->cs_packed + t * 12;
    int raw = pk[0];
    // thresh = int(abs_or_pct(...)) zero-out inside sw_full_cs
    int64_t thresh = (int64_t)pp_abs_or_pct(leg_thr,
                                            (double)w->score_max[t]);
    S.post[t] = 0.0;
    S.sf[t] = 0;
    S.pct_sf[t] = 0;
    if (raw <= 0 || raw < thresh) return;
    cseval::Result ev;
    if (!cseval::eval_hit(csm->ctx, csm->sc, ri, pk,
                          w->cs_steps + t * p->ops_words,
                          w->start_abs[t], w->gen_st[t] != 0, ev)) {
      return;
    }
    S.post[t] = ev.posterior;
    S.sf[t] = (int32_t)ev.ps;
    S.pct_sf[t] = (1000LL * 100LL * ev.ps) / w->score_max[t];
    csm->res.emplace((int32_t)t, std::move(ev));
    return;
  }
  // int() truncation of the python gate (_pass2_dispatch)
  double thresh = pp_abs_or_pct(leg_thr, (double)w->score_max[t]);
  if (S.sv[t] < (int64_t)thresh) {
    S.sf[t] = 0;
    S.post[t] = 0.0;
    S.pct_sf[t] = 0;
    return;
  }
  const int32_t* pk = w->packed + t * 10;
  int swsc = pk[0];
  if (swsc <= 0) {
    S.sf[t] = swsc;
    S.post[t] = 0.0;
    S.pct_sf[t] = 0;
    return;
  }
  int rmapped = pk[1] - pk[4] + 1;
  double cc = 2.0 * p->alpha + p->beta;
  double post = pow(2.0, ((double)swsc - rmapped * cc) / p->alpha);
  double psd = p->alpha * log2(post) + rmapped * cc;
  long ps = (long)nearbyint(psd);
  if (ps < 0) ps = 0;
  S.post[t] = post;
  S.sf[t] = (int32_t)ps;
  S.pct_sf[t] = (1000LL * 100LL * ps) / w->score_max[t];
}

// one selected pair candidate / final paired hit
struct PairC {
  int32_t r0, r1;      // foot rows
  int64_t score, smax, pct, key;
  int64_t isize;       // signed (compute_paired_hit)
  int32_t order;       // insertion order (stable-sort tiebreak)
};

struct FootGeom {
  int64_t gs1, ge1;    // 1-based SAM coords
  int64_t fivep;
  int64_t gstart;      // gen_st-frame alignment start (dedup keys)
  int32_t rmapped, gmapped, ins, dele, mm;
};

static FootGeom pp_geom(const PPParams* p, const PPWin* w, int64_t t) {
  FootGeom g;
  int rs;
  if (p->cs) {
    const int16_t* pk = w->cs_packed + t * 12;
    rs = pk[5];
    int nops = pk[4];
    g.ins = pk[9];
    g.dele = pk[10];
    g.mm = pk[8];
    g.rmapped = nops - g.ins;
    g.gmapped = nops - g.dele;
    g.gstart = (int64_t)pk[6] + w->g_off_norm[t];
  } else {
    const int32_t* pk = w->packed + t * 10;
    rs = pk[4];
    g.rmapped = pk[1] - rs + 1;
    g.gmapped = pk[2] - pk[5] + 1;
    g.ins = pk[8];
    g.dele = pk[9];
    g.mm = pk[7];
    g.gstart = (int64_t)pk[5] + w->g_off_norm[t];
  }
  int64_t glen_c = (int64_t)p->contig_lengths[w->cn[t]];
  int rs1 = rs + 1, re1 = rs1 + g.rmapped - 1;
  if (w->gen_st[t] == 0) {
    g.gs1 = g.gstart + 1;
  } else {
    int64_t right = glen_c - g.gstart;
    g.gs1 = right - (re1 - rs1 - g.dele + g.ins);
  }
  g.ge1 = g.gs1 + g.gmapped - 1;
  g.fivep = (w->gen_st[t] == 1) ? g.ge1 : g.gs1 - 1;
  return g;
}

// get_insert_size (mapping.c:405-456), 0 across contigs
static int64_t pp_insert_size(const PPParams* p, const PPWin* w,
                              int64_t t0, int64_t t1) {
  if (w->cn[t0] != w->cn[t1]) return 0;
  FootGeom a = pp_geom(p, w, t0), b = pp_geom(p, w, t1);
  return b.fivep - a.fivep;
}

static PairC pp_make_pair(const PPParams* p, const PPWin* w, WinState& S,
                          int32_t r0, int32_t r1, bool absolute,
                          int32_t order) {
  PairC c;
  c.r0 = r0;
  c.r1 = r1;
  c.smax = w->score_max[r0] + w->score_max[r1];
  c.score = (int64_t)S.sf[r0] + S.sf[r1];
  c.pct = (1000LL * 100LL * c.score) / c.smax;
  c.key = absolute ? c.score : c.pct;
  int64_t ins = pp_insert_size(p, w, r0, r1);
  int sign;
  if (p->mode_sign_st0)
    sign = (w->gen_st[r0] == 0) ? 1 : -1;
  else
    sign = (w->gen_st[r0] == 1) ? 1 : -1;
  c.isize = sign * ins;
  c.order = order;
  return c;
}

// read_pass1_per_strand walk over one read's two strand groups
// (mapping.c:1261-1339); mutates sv/pct_sv
static void pp_pass1_walk(const PPParams* p, const PPWin* w, WinState& S,
                          int64_t o_st0, bool only_paired,
                          const std::vector<int32_t>& pair_min,
                          int min_matches, double threshold, int overlap) {
  for (int st = 0; st < 2; st++) {
    int64_t lo = w->seg[o_st0 + st], hi = w->seg[o_st0 + st + 1];
    bool lg_valid = false;
    int32_t lg_cn = 0;
    int64_t lg_goff = 0;
    for (int64_t t = lo; t < hi; t++) {
      if (only_paired && pair_min[t] < 0) continue;
      if (w->matches[t] < min_matches) continue;
      if (S.saved[t] == 1) {
        lg_valid = true;
        lg_cn = w->cn[t];
        lg_goff = w->g_off[t];
        continue;
      }
      if (lg_valid && w->cn[t] == lg_cn &&
          w->g_off[t] + overlap <= lg_goff + p->window_len) {
        S.sv[t] = 0;
        S.pct_sv[t] = 0;
        continue;
      }
      if (S.sv[t] <= 0) {
        S.sv[t] = w->vec[t];
        S.pct_sv[t] = (1000LL * 100LL * S.sv[t]) / w->score_max[t];
        if (S.sv[t] >=
            (int64_t)pp_abs_or_pct(threshold, (double)w->score_max[t])) {
          lg_valid = true;
          lg_cn = w->cn[t];
          lg_goff = w->g_off[t];
        }
      }
    }
  }
}

// grouped duplicate removal keeping first max key (_dedup /
// read_remove_duplicate_hits): rows by 3-tuple key
struct DedupKey {
  int64_t k0, k1, k2;
  bool operator<(const DedupKey& o) const {
    if (k0 != o.k0) return k0 < o.k0;
    if (k1 != o.k1) return k1 < o.k1;
    return k2 < o.k2;
  }
  bool operator==(const DedupKey& o) const {
    return k0 == o.k0 && k1 == o.k1 && k2 == o.k2;
  }
};

int64_t paired_finalize_render(const PPParams* p, const PPWin* w,
                               char* out_buf, int64_t out_cap,
                               int32_t* pair_nhits,
                               int32_t* read_nhits) {
  const int64_t n = p->n_windows;
  const int R = p->read_len;
  CSMode cs_state;
  CSMode* csm = nullptr;
  if (p->cs) {
    csm = &cs_state;
    cseval::Ctx& c = cs_state.ctx;
    c.genome_fwd = p->cs_genome_fwd;
    c.genome_rc = p->cs_genome_rc;
    c.colours = p->cs_colours;
    c.qr_tab = p->cs_qr_tab;
    c.initbp = p->cs_initbp;
    c.quals = p->cs_quals;
    c.R = R;
    c.steps_words = p->ops_words;
    c.alpha = p->alpha;
    c.beta = p->beta;
    c.pr_xover = p->pr_xover;
    c.pr_snp = p->pr_snp;
    c.pr_del_open = p->pr_del_open;
    c.pr_del_extend = p->pr_del_extend;
    c.pr_ins_open = p->pr_ins_open;
    c.pr_ins_extend = p->pr_ins_extend;
    c.qual_delta = p->cs_qual_delta;
    c.use_sanger_qvs = p->cs_use_sanger;
    c.use_read_qvs = p->cs_use_read_qvs != 0;
    c.want_qual = p->cs_fastq != 0;
    c.la_match = log(1 - p->pr_snp);
    c.la_mis = log(p->pr_snp / 3.0);
  }
  WinState S;
  S.sv.assign(n, -1);
  S.pct_sv.assign(n, 0);
  S.pass2_key.assign(n, 0);
  S.saved.assign(n, 0);
  S.ran.assign(n, 0);
  S.sf.assign(n, -1);
  S.post.assign(n, 0.0);
  S.pct_sf.assign(n, 0);
  std::vector<int32_t> pair_min(n, -1), pair_max(n, -1);

  char* wp = out_buf;
  char* end = out_buf + out_cap;

  const bool abs_pair1 = p->pair1_threshold < 0;
  const bool abs_pair2 = p->pair2_threshold < 0;
  const bool abs_hp = p->hp_threshold < 0;
  const bool abs_hp_full = p->hp_full_threshold < 0;
  const double prm = (R < 40) ? 1e-10 : (R < 60 ? 1e-14 : 1e-16);

  std::vector<PPHeapEnt> heap(std::max(
      std::max(p->pair1_num_outputs, p->hp_num_tmp),
      p->hp_num_tmp + p->pair2_num_outputs) + 1);
  std::vector<PairC> sel, pairs;
  std::vector<int32_t> hp_out[2];
  int64_t nsel = 0;

  for (int64_t pi = 0; pi < p->n_pairs; pi++) {
    int64_t o0 = 4 * pi;          // leg0 st0 owner
    int64_t o1 = 4 * pi + 2;      // leg1 st0 owner

    // ---- pair_up (readpair_pair_up_hits): leg0 strand st vs leg1
    // strand 1-st, by g_off delta window in strand coords
    for (int st1 = 0; st1 < 2; st1++) {
      int st2 = 1 - st1;
      int64_t alo = w->seg[o0 + st1], ahi = w->seg[o0 + st1 + 1];
      int64_t blo = w->seg[o1 + st2], bhi = w->seg[o1 + st2 + 1];
      int64_t dmin = p->d_min[st1], dmax = p->d_max[st1];
      int64_t j = blo;
      for (int64_t i = alo; i < ahi; i++) {
        while (j < bhi &&
               (w->cn[j] < w->cn[i] ||
                (w->cn[j] == w->cn[i] &&
                 w->g_off[j] < w->g_off[i] + dmin)))
          j++;
        int64_t k = j;
        while (k < bhi && w->cn[k] == w->cn[i] &&
               w->g_off[k] <= w->g_off[i] + dmax)
          k++;
        if (j == k) continue;
        pair_min[i] = (int32_t)j;
        pair_max[i] = (int32_t)(k - 1);
        for (int64_t l = j; l < k; l++) {
          if (pair_min[l] < 0) pair_min[l] = (int32_t)i;
          pair_max[l] = (int32_t)i;
        }
      }
    }

    // ---- paired pass1 walk per leg (only_paired=1)
    pp_pass1_walk(p, w, S, o0, true, pair_min, p->p1_min_matches,
                  p->p1_threshold, p->p1_overlap);
    pp_pass1_walk(p, w, S, o1, true, pair_min, p->p1_min_matches,
                  p->p1_threshold, p->p1_overlap);

    // ---- readpair_get_vector_hits: extheap on combined scores
    int load = 0;
    for (int st1 = 0; st1 < 2; st1++) {
      int st2 = 1 - st1;
      int64_t alo = w->seg[o0 + st1], ahi = w->seg[o0 + st1 + 1];
      (void)st2;
      for (int64_t i = alo; i < ahi; i++) {
        if (S.saved[i] == 1 || pair_min[i] < 0) continue;
        for (int64_t l = pair_min[i]; l <= pair_max[i]; l++) {
          if (S.saved[l] == 1) continue;
          int64_t score = S.sv[i] + S.sv[l];
          int64_t smax2 = w->score_max[i] + w->score_max[l];
          // floor division (score guaranteed >= 0 when kept)
          if (score <
              (int64_t)pp_abs_or_pct(p->pair1_threshold, (double)smax2))
            continue;
          int64_t pct = (1000LL * 100LL * score) / smax2;
          int64_t key = abs_pair1 ? score : pct;
          if (load < p->pair1_num_outputs) {
            pp_heap_insert(heap.data(), load,
                           {key, (int32_t)i, (int32_t)l});
          } else if (key > heap[0].key) {
            pp_heap_replace_min(heap.data(), load,
                                {key, (int32_t)i, (int32_t)l});
          }
        }
      }
    }

    if (p->select_only) {
      // record the paired heap feet, then the hp heap SUPERSET per leg
      // (header comment: hp_num_tmp + pair2_num_outputs covers every
      // row the render-pass hp heap can keep after saved exclusions)
      for (int h = 0; h < load; h++) {
        p->sel_out[nsel++] = heap[h].a;
        p->sel_out[nsel++] = heap[h].b;
      }
      if (p->hp_enabled) {
        for (int nip = 0; nip < 2; nip++) {
          int64_t os = nip == 0 ? o0 : o1;
          pp_pass1_walk(p, w, S, os, false, pair_min, p->hp_min_matches,
                        p->hp_threshold, p->hp_overlap);
          int hcap = p->hp_num_tmp + p->pair2_num_outputs;
          int hload = 0;
          for (int st = 0; st < 2; st++) {
            int64_t lo = w->seg[os + st], hi = w->seg[os + st + 1];
            for (int64_t t = lo; t < hi; t++) {
              int64_t key = abs_hp ? S.sv[t] : S.pct_sv[t];
              if (S.sv[t] < (int64_t)pp_abs_or_pct(
                      p->hp_threshold, (double)w->score_max[t]))
                continue;
              if (hload < hcap)
                pp_heap_insert(heap.data(), hload,
                               {key, (int32_t)t, 0});
              else if (key > heap[0].key)
                pp_heap_replace_min(heap.data(), hload,
                                    {key, (int32_t)t, 0});
            }
          }
          for (int h = 0; h < hload; h++)
            p->sel_out[nsel++] = heap[h].a;
        }
      }
      continue;
    }

    // ---- full SW on selected feet (speculative results + gate)
    sel.clear();
    for (int h = 0; h < load; h++) {
      pp_run_full(p, w, S, heap[h].a, p->foot_threshold, csm, 2 * pi);
      pp_run_full(p, w, S, heap[h].b, p->foot_threshold, csm,
                  2 * pi + 1);
    }

    // ---- readpair_pass2: pair threshold
    pairs.clear();
    for (int h = 0; h < load; h++) {
      int32_t r0 = heap[h].a, r1 = heap[h].b;
      if (S.sf[r0] == 0 || S.sf[r1] == 0) continue;
      int64_t smax2 = w->score_max[r0] + w->score_max[r1];
      if ((int64_t)S.sf[r0] + S.sf[r1] >=
          (int64_t)pp_abs_or_pct(p->pair2_threshold, (double)smax2))
        pairs.push_back(pp_make_pair(p, w, S, r0, r1, abs_pair2,
                                     (int32_t)pairs.size()));
    }

    // ---- duplicate pair removal (readpair_remove_duplicate_hits):
    // 4 dominant passes then identity uniq
    auto dominant = [&](int nip, bool end_key) {
      auto keyf = [&](const PairC& c) -> DedupKey {
        int64_t t = nip == 0 ? c.r0 : c.r1;
        FootGeom g = pp_geom(p, w, t);
        if (!end_key)
          return {w->cn[t], (int64_t)w->gen_st[t], g.gstart};
        return {w->cn[t], (int64_t)w->gen_st[t],
                -g.gstart - g.rmapped + g.dele - g.ins};
      };
      std::stable_sort(pairs.begin(), pairs.end(),
                       [&](const PairC& x, const PairC& y) {
                         return keyf(x) < keyf(y);
                       });
      size_t i = 0;
      while (i < pairs.size()) {
        size_t j = i, best = i;
        while (j + 1 < pairs.size() &&
               keyf(pairs[j + 1]) == keyf(pairs[i])) {
          j++;
          int32_t tb = nip == 0 ? pairs[best].r0 : pairs[best].r1;
          int32_t tj = nip == 0 ? pairs[j].r0 : pairs[j].r1;
          if (S.sf[tj] > S.sf[tb]) best = j;
        }
        for (size_t k = i; k <= j; k++) {
          if (k == best) continue;
          int32_t br = nip == 0 ? pairs[best].r0 : pairs[best].r1;
          int32_t nr0 = nip == 0 ? br : pairs[k].r0;
          int32_t nr1 = nip == 0 ? pairs[k].r1 : br;
          int32_t ord = pairs[k].order;
          pairs[k] = pp_make_pair(p, w, S, nr0, nr1, abs_pair2, ord);
        }
        i = j + 1;
      }
    };
    if (!pairs.empty()) {
      dominant(0, false);
      dominant(0, true);
      dominant(1, false);
      dominant(1, true);
      // sort by (sort_idx0, sort_idx1); sort_idx = row - read st0 start
      std::stable_sort(pairs.begin(), pairs.end(),
                       [&](const PairC& x, const PairC& y) {
                         int64_t xa = x.r0 - w->seg[o0];
                         int64_t ya = y.r0 - w->seg[o0];
                         if (xa != ya) return xa < ya;
                         return x.r1 - w->seg[o1] < y.r1 - w->seg[o1];
                       });
      std::vector<PairC> uq;
      for (auto& c : pairs) {
        if (!uq.empty() && uq.back().r0 == c.r0 && uq.back().r1 == c.r1)
          continue;
        uq.push_back(c);
      }
      pairs.swap(uq);
      std::stable_sort(pairs.begin(), pairs.end(),
                       [](const PairC& x, const PairC& y) {
                         return x.key > y.key;
                       });
      if ((int64_t)pairs.size() > p->pair2_num_outputs)
        pairs.resize(p->pair2_num_outputs);
      if (p->strata && !pairs.empty()) {
        size_t i = 1;
        while (i < pairs.size() && pairs[0].score == pairs[i].score) i++;
        pairs.resize(i);
      }
      if (p->max_alignments > 0 &&
          (int64_t)pairs.size() > p->max_alignments)
        pairs.clear();
      for (auto& c : pairs) {
        S.saved[c.r0] = 1;
        S.saved[c.r1] = 1;
      }
    }
    pair_nhits[pi] = (int32_t)pairs.size();

    // ---- half-paired fallback per leg (handle_readpair
    // mapping.c:2607-2611 with the gmapper.c:2700-2716 option set)
    hp_out[0].clear();
    hp_out[1].clear();
    if (p->hp_enabled) {
      for (int nip = 0; nip < 2; nip++) {
        int64_t os = nip == 0 ? o0 : o1;
        pp_pass1_walk(p, w, S, os, false, pair_min, p->hp_min_matches,
                      p->hp_threshold, p->hp_overlap);
        int hload = 0;
        for (int st = 0; st < 2; st++) {
          int64_t lo = w->seg[os + st], hi = w->seg[os + st + 1];
          for (int64_t t = lo; t < hi; t++) {
            if (S.saved[t] == 1) continue;
            int64_t key = abs_hp ? S.sv[t] : S.pct_sv[t];
            if (S.sv[t] < (int64_t)pp_abs_or_pct(
                    p->hp_threshold, (double)w->score_max[t]))
              continue;
            if (hload < p->hp_num_tmp)
              pp_heap_insert(heap.data(), hload, {key, (int32_t)t, 0});
            else if (key > heap[0].key)
              pp_heap_replace_min(heap.data(), hload,
                                  {key, (int32_t)t, 0});
          }
        }
        // full SW for feet never run; fresh ones get pass2_key
        // (_run_option_sets fresh semantics)
        std::vector<int32_t> srows;
        for (int h = 0; h < hload; h++) {
          int32_t t = heap[h].a;
          if (!S.ran[t]) {
            pp_run_full(p, w, S, t, p->hp_full_threshold, csm,
                        2 * pi + nip);
            S.pass2_key[t] = abs_hp_full ? S.sf[t] : S.pct_sf[t];
          }
          srows.push_back(t);
        }
        // _finalize: threshold, dedup x2, sort, caps
        std::vector<int32_t> surv;
        for (int32_t t : srows)
          if ((double)S.sf[t] >=
              pp_abs_or_pct(p->hp_full_threshold,
                            (double)w->score_max[t]))
            surv.push_back(t);
        if (surv.size() > 1) {
          for (int passk = 0; passk < 2; passk++) {
            auto keyf = [&](int32_t t) -> DedupKey {
              FootGeom g = pp_geom(p, w, t);
              if (passk == 0)
                return {w->cn[t], (int64_t)w->gen_st[t], g.gstart};
              return {w->cn[t], (int64_t)w->gen_st[t],
                      -g.gstart - g.rmapped + g.dele - g.ins};
            };
            std::vector<int32_t> order(surv.size());
            for (size_t q = 0; q < surv.size(); q++)
              order[q] = (int32_t)q;
            std::stable_sort(order.begin(), order.end(),
                             [&](int32_t x, int32_t y) {
                               return keyf(surv[x]) < keyf(surv[y]);
                             });
            // _dedup keeps the first max pass2_key per key group, in
            // sorted-key group order
            std::vector<int32_t> outv;
            size_t i = 0;
            while (i < order.size()) {
              size_t j = i;
              int32_t best_row = surv[order[i]];
              while (j + 1 < order.size() &&
                     keyf(surv[order[j + 1]]) == keyf(surv[order[i]])) {
                j++;
                if (S.pass2_key[surv[order[j]]] > S.pass2_key[best_row])
                  best_row = surv[order[j]];
              }
              outv.push_back(best_row);
              i = j + 1;
            }
            surv.swap(outv);
          }
          std::stable_sort(surv.begin(), surv.end(),
                           [&](int32_t x, int32_t y) {
                             return S.pass2_key[x] > S.pass2_key[y];
                           });
        }
        if ((int64_t)surv.size() > p->hp_num_outputs)
          surv.resize(p->hp_num_outputs);
        if (p->strata && !surv.empty()) {
          size_t i = 1;
          while (i < surv.size() && S.sf[surv[0]] == S.sf[surv[i]]) i++;
          surv.resize(i);
        }
        if (p->max_alignments > 0 &&
            (int64_t)surv.size() > p->max_alignments)
          surv.clear();
        for (int32_t t : surv) S.saved[t] = 1;
        hp_out[nip] = surv;
        read_nhits[2 * pi + nip] = (int32_t)surv.size();
      }
    } else {
      read_nhits[2 * pi] = read_nhits[2 * pi + 1] = 0;
    }

    // ---- paired MQV (compute_paired_mqv, output.c:811-942)
    double up_z1[2] = {0.0, 0.0};
    double up_z4[2] = {1.0, 1.0};     // pr_top_random_at_location
    std::vector<double> ft_z2[2];     // per unique foot
    std::vector<int32_t> ft_rows[2];
    double z3 = 0.0, ins_denom = 0.0;
    double pr_top[3] = {1.0, 1.0, 1.0};
    double pr2_pre = 1.0;             // Z4 value for paired feet
    std::vector<int> pr_mqv[2];       // mqv per unique foot

    // per-(pair, shard) partials for the cross-shard collective merge
    double* part = nullptr;
    if (p->part_out) {
      part = p->part_out + (int64_t)pi * p->n_shards * 9;
      for (int s = 0; s < p->n_shards; s++) {
        double* row = part + s * 9;
        row[0] = row[1] = row[2] = row[3] = 0.0;   // z1a z1b insden z3
        row[4] = row[6] = -1.0;                    // best_post sentinels
        row[5] = row[7] = 1.0;                     // z4 defaults
        row[8] = 1.0;                              // pr2 min (cap 1.0)
      }
    }
    auto shard_of = [&](int32_t t) {
      return p->win_shard ? (int)p->win_shard[t] : 0;
    };

    if (p->compute_mqv) {
      for (int nip = 0; nip < 2; nip++)
        for (int32_t t : hp_out[nip]) {
          up_z1[nip] += S.post[t];
          if (part) part[shard_of(t) * 9 + nip] += S.post[t];
        }
      for (auto& c : pairs) {
        ins_denom += pp_pr_insert(p, (double)c.isize);
        if (part)
          part[shard_of(c.r0) * 9 + 2] +=
              pp_pr_insert(p, (double)c.isize);
      }
      // unique feet per leg in first-appearance order
      for (auto& c : pairs) {
        int32_t rr[2] = {c.r0, c.r1};
        for (int nip = 0; nip < 2; nip++) {
          bool seen = false;
          for (int32_t q : ft_rows[nip])
            if (q == rr[nip]) { seen = true; break; }
          if (!seen) ft_rows[nip].push_back(rr[nip]);
        }
      }
      for (int nip = 0; nip < 2; nip++) {
        for (int32_t t : ft_rows[nip]) {
          double tmp = 0.0;
          for (auto& c : pairs) {
            int32_t self_r = nip == 0 ? c.r0 : c.r1;
            int32_t mate_r = nip == 0 ? c.r1 : c.r0;
            if (self_r != t) continue;
            tmp += pp_pr_insert(p, (double)c.isize) * S.post[mate_r];
          }
          tmp *= S.post[t];
          if (tmp < 1e-200) tmp = 1e-200;
          ft_z2[nip].push_back(tmp);
          if (nip == 0) {
            z3 += tmp;
            if (part) part[shard_of(t) * 9 + 3] += tmp;
          }
        }
      }
      // class priors
      for (int nip = 0; nip < 2; nip++) {
        if (hp_out[nip].empty()) continue;
        size_t mi = 0;
        for (size_t q = 1; q < hp_out[nip].size(); q++)
          if (S.post[hp_out[nip][q]] > S.post[hp_out[nip][mi]]) mi = q;
        double pr = pp_pr_random(p, S.sf[hp_out[nip][mi]]);
        up_z4[nip] = pr;
        pr_top[nip] = pr * p->total_genome_size;
        if (pr_top[nip] > 1.0) pr_top[nip] = 1.0;
        if (part) {
          // per-shard first-max best + its prior (merged externally
          // by argmax of best_post, lowest shard wins ties)
          for (int32_t t : hp_out[nip]) {
            double* row = part + shard_of(t) * 9;
            if (S.post[t] > row[4 + 2 * nip]) {
              row[4 + 2 * nip] = S.post[t];
              row[5 + 2 * nip] = pp_pr_random(p, S.sf[t]);
            }
          }
        }
      }
      for (auto& c : pairs) {
        double tmp = pp_pr_random(p, S.sf[c.r0]) *
                     pp_pr_random(p, S.sf[c.r1]) * 1000.0;
        if (tmp < pr_top[2]) pr_top[2] = tmp;
        if (part) {
          double* row = part + shard_of(c.r0) * 9;
          if (tmp < row[8]) row[8] = tmp;
        }
      }
      pr2_pre = pr_top[2];
      pr_top[2] = pr_top[2] * p->total_genome_size;
      if (pr_top[2] > 1.0) pr_top[2] = 1.0;

      if (p->ext_in) {
        // collective-merged statistics replace the local sums
        // (byte-identity: the merged windows make the local and merged
        // values mathematically equal; the override makes the
        // collective's OUTPUT the one the render consumes)
        const double* e = p->ext_in + (int64_t)pi * 7;
        up_z1[0] = e[0];
        up_z1[1] = e[1];
        ins_denom = e[2];
        z3 = e[3] > 0.0 ? e[3] : z3;
        for (int nip = 0; nip < 2; nip++) {
          if (hp_out[nip].empty()) continue;
          up_z4[nip] = e[4 + nip];
          pr_top[nip] = e[4 + nip] * p->total_genome_size;
          if (pr_top[nip] > 1.0) pr_top[nip] = 1.0;
        }
        pr2_pre = e[6];
        pr_top[2] = e[6] * p->total_genome_size;
        if (pr_top[2] > 1.0) pr_top[2] = 1.0;
      }

      double denom = 0.0;
      if (!hp_out[0].empty()) denom += pr_top[1] * pr_top[2] * prm;
      if (!hp_out[1].empty()) denom += pr_top[0] * pr_top[2] * prm;
      if (!pairs.empty()) denom += pr_top[0] * pr_top[1];

      for (int nip = 0; nip < 2; nip++) {
        pr_mqv[nip].clear();
        for (size_t q = 0; q < ft_rows[nip].size(); q++) {
          double pc = (pr_top[0] * pr_top[1] / denom) *
                      (ft_z2[nip][q] / z3);
          int m = pp_qv_from_pr_corr(pc);
          if (m < 4) m = 0;
          pr_mqv[nip].push_back(m);
        }
      }
      // unpaired (half-paired) mqvs are computed inline at render,
      // reusing the same denom
      (void)denom;
    }

    // ---------- render ----------
    auto foot_index = [&](int nip, int32_t t) -> int {
      for (size_t q = 0; q < ft_rows[nip].size(); q++)
        if (ft_rows[nip][q] == t) return (int)q;
      return -1;
    };
    auto emit_line = [&](int nip, int32_t t, int32_t mate_t, bool paired,
                         int mqv, double zA, double zB, double z4v,
                         double z5or6, bool z56_is_6) -> bool {
      int64_t ri = 2 * pi + nip;
      int64_t nl = p->name_off[ri + 1] - p->name_off[ri];
      if (end - wp < 640 + 12 * (int64_t)R + 2 * nl + p->rg_len
                     + (p->cs ? 3 * (int64_t)R + 3 * p->cs_read_seq_len
                              : 0))
        return false;
      const char* nm = p->names + p->name_off[ri];
      int64_t ri_mp = 2 * pi + (1 - nip);
      const char* nm_mp = p->names + p->name_off[ri_mp];
      int64_t nl_mp = p->name_off[ri_mp + 1] - p->name_off[ri_mp];
      // pair qname: longest common prefix, trailing :/ stripped
      int64_t ci = 0, cn_ = std::min(nl, nl_mp);
      while (ci < cn_ && nm[ci] == nm_mp[ci]) ci++;
      if (ci > 0 && (nm[ci - 1] == ':' || nm[ci - 1] == '/')) ci--;
      memcpy(wp, nm, ci);
      wp += ci;
      *wp++ = '\t';

      FootGeom g = pp_geom(p, w, t);
      bool rev = w->gen_st[t] != 0;
      bool mate_unmapped = mate_t < 0;
      bool rev_mp = false;
      int64_t mpos = 0;
      FootGeom gm;
      if (!mate_unmapped) {
        gm = pp_geom(p, w, mate_t);
        rev_mp = w->gen_st[mate_t] != 0;
        mpos = gm.gs1;
      }
      int flags = 0x1 | (paired ? 0x2 : 0) | (mate_unmapped ? 0x8 : 0) |
                  (rev ? 0x10 : 0) | (rev_mp ? 0x20 : 0) |
                  (nip == 0 ? 0x40 : 0x80);
      wp += sprintf(wp, "%d\t", flags);
      int32_t cnum = w->cn[t];
      int32_t cl = p->contig_name_off[cnum + 1] - p->contig_name_off[cnum];
      memcpy(wp, p->contig_names + p->contig_name_off[cnum], cl);
      wp += cl;
      wp += sprintf(wp, "\t%lld\t%d\t", (long long)g.gs1, mqv);
      // CIGAR
      if (p->cs) {
        const cseval::Result& ev = csm->res.at((int32_t)t);
        if (!rev) {
          for (size_t q = 0; q < ev.cig_n.size(); q++)
            wp += sprintf(wp, "%d%c", ev.cig_n[q], ev.cig_c[q]);
        } else {
          for (size_t q = ev.cig_n.size(); q-- > 0;)
            wp += sprintf(wp, "%d%c", ev.cig_n[q], ev.cig_c[q]);
        }
      } else {
        const int32_t* pk = w->packed + t * 10;
        int rs = pk[4], nops = pk[3];
        int read_end1 = rs + g.rmapped;
        int runs_n[4096];
        char runs_c[4096];
        int nr = 0;
        if (rs > 0) { runs_n[nr] = rs; runs_c[nr++] = 'S'; }
        const uint8_t* opw = w->ops_pk + t * p->ops_words;
        int prev = -1, cnt = 0;
        for (int q = nops - 1; q >= 0; q--) {
          int op = (opw[q >> 2] >> ((q & 3) * 2)) & 3;
          if (op == prev) { cnt++; continue; }
          if (cnt && nr < 4095) {
            runs_n[nr] = cnt;
            runs_c[nr++] = prev == 2 ? 'I' : (prev == 1 ? 'D' : 'M');
          }
          prev = op;
          cnt = 1;
        }
        if (cnt && nr < 4095) {
          runs_n[nr] = cnt;
          runs_c[nr++] = prev == 2 ? 'I' : (prev == 1 ? 'D' : 'M');
        }
        if (read_end1 != R) {
          runs_n[nr] = R - read_end1;
          runs_c[nr++] = 'S';
        }
        if (!rev)
          for (int q = 0; q < nr; q++)
            wp += sprintf(wp, "%d%c", runs_n[q], runs_c[q]);
        else
          for (int q = nr - 1; q >= 0; q--)
            wp += sprintf(wp, "%d%c", runs_n[q], runs_c[q]);
      }
      // mate fields
      if (mate_unmapped) {
        memcpy(wp, "\t*\t0\t0\t", 7);
        wp += 7;
      } else {
        int64_t isize = 0;
        if (w->cn[t] == w->cn[mate_t]) {
          isize = gm.fivep - g.fivep;
          wp += sprintf(wp, "\t=\t%lld\t%lld\t", (long long)mpos,
                        (long long)isize);
        } else {
          *wp++ = '\t';
          int32_t c2 = w->cn[mate_t];
          int32_t l2 = p->contig_name_off[c2 + 1] - p->contig_name_off[c2];
          memcpy(wp, p->contig_names + p->contig_name_off[c2], l2);
          wp += l2;
          wp += sprintf(wp, "\t%lld\t0\t", (long long)mpos);
        }
      }
      if (p->cs) {
        // SEQ = post-SW called letters; QUAL = post-SW base quals
        const cseval::Result& ev = csm->res.at((int32_t)t);
        if (!rev) {
          memcpy(wp, ev.seq.data(), ev.seq.size());
          wp += ev.seq.size();
        } else {
          static const char comp_[5] = "TGCA";
          for (size_t q = ev.seq.size(); q-- > 0;) {
            uint8_t c = ev.seq[q];
            int code = (c == 'A') ? 0 : (c == 'C') ? 1
                       : (c == 'G') ? 2 : 3;
            *wp++ = comp_[code];
          }
        }
        *wp++ = '\t';
        if (p->cs_fastq && !ev.qual.empty()) {
          if (!rev) {
            memcpy(wp, ev.qual.data(), ev.qual.size());
            wp += ev.qual.size();
          } else {
            for (size_t q = ev.qual.size(); q-- > 0;)
              *wp++ = (char)ev.qual[q];
          }
        } else {
          *wp++ = '*';
        }
      } else {
        const uint8_t* sq = (rev ? p->seq_rc : p->seq_fwd) + ri * R;
        memcpy(wp, sq, R);
        wp += R;
        *wp++ = '\t';
        if (p->qual_fwd) {
          const uint8_t* qq = (rev ? p->qual_rc : p->qual_fwd) + ri * R;
          memcpy(wp, qq, R);
          wp += R;
        } else {
          *wp++ = '*';
        }
      }
      wp += sprintf(wp, "\tAS:i:%d", S.sf[t]);
      if (p->compute_mqv && !p->all_contigs) {
        if (paired) {
          wp += sprintf(wp, "\tZ2:i:%d\tZ3:i:%d\tZ4:i:%d\tZ6:i:%d",
                        pp_neglog(zA), pp_neglog(zB), pp_neglog(z4v),
                        pp_neglog(z5or6));
        } else {
          wp += sprintf(wp, "\tZ0:i:%d\tZ1:i:%d\tZ4:i:%d\tZ5:i:%d",
                        pp_neglog(zA), pp_neglog(zB), pp_neglog(z4v),
                        pp_neglog(z5or6));
        }
      }
      if (p->cs) {
        const cseval::Result& ev = csm->res.at((int32_t)t);
        wp += sprintf(wp, "\tNM:i:%d", ev.mismatches + g.dele + g.ins);
        if (p->cs_fastq && p->cs_cq) {
          memcpy(wp, "\tCQ:Z:", 6);
          wp += 6;
          memcpy(wp, p->cs_cq + (int64_t)ri * p->cs_cq_len,
                 p->cs_cq_len);
          wp += p->cs_cq_len;
        }
        memcpy(wp, "\tCS:Z:", 6);
        wp += 6;
        memcpy(wp, p->cs_readseq + (int64_t)ri * p->cs_read_seq_len,
               p->cs_read_seq_len);
        wp += p->cs_read_seq_len;
        wp += sprintf(wp, "\tCM:i:%d", ev.crossovers);
        memcpy(wp, "\tXX:Z:", 6);
        wp += 6;
        memcpy(wp, ev.xx.data(), ev.xx.size());
        wp += ev.xx.size();
      } else {
        wp += sprintf(wp, "\tNM:i:%d", g.mm + g.dele + g.ins);
      }
      if (p->sam_r2) {
        int64_t ri_mp = 2 * pi + (1 - nip);
        if (p->cs) {
          memcpy(wp, "\tX2:Z:", 6);
          wp += 6;
          memcpy(wp, p->cs_readseq + ri_mp * p->cs_read_seq_len,
                 p->cs_read_seq_len);
          wp += p->cs_read_seq_len;
        } else {
          memcpy(wp, "\tR2:Z:", 6);
          wp += 6;
          memcpy(wp, p->seq_raw + ri_mp * R, R);
          wp += R;
        }
      }
      if (p->rg_len) {
        memcpy(wp, p->rg, p->rg_len);
        wp += p->rg_len;
      }
      *wp++ = '\n';
      (void)z56_is_6;
      return true;
    };

    // unmapped-style record for the mate of a half-paired hit
    // (hit_output, output.c:417-474; render order output.c:1256-1267)
    auto emit_unmapped = [&](int nip, int32_t mate_t) -> bool {
      int64_t ri = 2 * pi + nip;
      int64_t nl = p->name_off[ri + 1] - p->name_off[ri];
      if (end - wp < 256 + 4 * (int64_t)R + 2 * nl + p->rg_len
                     + (p->cs ? 3 * p->cs_read_seq_len : 0))
        return false;
      const char* nm = p->names + p->name_off[ri];
      int64_t ri_mp = 2 * pi + (1 - nip);
      const char* nm_mp = p->names + p->name_off[ri_mp];
      int64_t nl_mp = p->name_off[ri_mp + 1] - p->name_off[ri_mp];
      int64_t ci = 0, cn_ = std::min(nl, nl_mp);
      while (ci < cn_ && nm[ci] == nm_mp[ci]) ci++;
      if (ci > 0 && (nm[ci - 1] == ':' || nm[ci - 1] == '/')) ci--;
      memcpy(wp, nm, ci);
      wp += ci;
      FootGeom gm = pp_geom(p, w, mate_t);
      bool rev_mp = w->gen_st[mate_t] != 0;
      int flags = 0x1 | 0x4 | (rev_mp ? 0x20 : 0) |
                  (nip == 0 ? 0x40 : 0x80);
      wp += sprintf(wp, "\t%d\t*\t0\t0\t*\t", flags);
      int32_t c2 = w->cn[mate_t];
      int32_t l2 = p->contig_name_off[c2 + 1] - p->contig_name_off[c2];
      memcpy(wp, p->contig_names + p->contig_name_off[c2], l2);
      wp += l2;
      wp += sprintf(wp, "\t%lld\t0\t", (long long)gm.gs1);
      if (p->cs) {
        // CS unmapped-style record: SEQ/QUAL are '*', the raw read and
        // quals ride in CS:Z / CQ:Z (hit_output, output.c:440-452)
        memcpy(wp, "*\t*", 3);
        wp += 3;
        memcpy(wp, "\tCQ:Z:", 6);
        wp += 6;
        if (p->cs_fastq && p->cs_cq) {
          memcpy(wp, p->cs_cq + (int64_t)ri * p->cs_cq_len,
                 p->cs_cq_len);
          wp += p->cs_cq_len;
        } else {
          *wp++ = '*';
        }
        memcpy(wp, "\tCS:Z:", 6);
        wp += 6;
        memcpy(wp, p->cs_readseq + (int64_t)ri * p->cs_read_seq_len,
               p->cs_read_seq_len);
        wp += p->cs_read_seq_len;
      } else {
        memcpy(wp, p->seq_fwd + ri * R, R);
        wp += R;
        *wp++ = '\t';
        if (p->qual_raw) {
          // unmapped record: RAW forward quals, no rescale
          // (output.c:419)
          memcpy(wp, p->qual_raw + ri * R, R);
          wp += R;
        } else {
          *wp++ = '*';
        }
      }
      if (p->sam_r2) {
        if (p->cs) {
          memcpy(wp, "\tX2:Z:", 6);
          wp += 6;
          memcpy(wp, p->cs_readseq + ri_mp * p->cs_read_seq_len,
                 p->cs_read_seq_len);
          wp += p->cs_read_seq_len;
        } else {
          memcpy(wp, "\tR2:Z:", 6);
          wp += 6;
          memcpy(wp, p->seq_raw + ri_mp * R, R);
          wp += R;
        }
      }
      if (p->rg_len) {
        memcpy(wp, p->rg, p->rg_len);
        wp += p->rg_len;
      }
      *wp++ = '\n';
      return true;
    };

    // --sam-unaligned: both-legs-unmapped records for a pair that
    // emitted nothing (render_pair_entry tail, output.c:417-474)
    auto emit_unaligned = [&](int nip) -> bool {
      int64_t ri = 2 * pi + nip;
      int64_t ri_mp = 2 * pi + (1 - nip);
      int64_t nl = p->name_off[ri + 1] - p->name_off[ri];
      if (end - wp < 128 + 3 * (int64_t)R + nl + p->rg_len
                     + (p->cs ? 3 * p->cs_read_seq_len + p->cs_cq_len
                              : 0))
        return false;
      const char* nm = p->names + p->name_off[ri];
      const char* nm_mp = p->names + p->name_off[ri_mp];
      int64_t nl_mp = p->name_off[ri_mp + 1] - p->name_off[ri_mp];
      int64_t ci = 0, cn_ = std::min(nl, nl_mp);
      while (ci < cn_ && nm[ci] == nm_mp[ci]) ci++;
      if (ci > 0 && (nm[ci - 1] == ':' || nm[ci - 1] == '/')) ci--;
      memcpy(wp, nm, ci);
      wp += ci;
      int flags = 0x1 | 0x4 | 0x8 | (nip == 0 ? 0x40 : 0x80);
      wp += sprintf(wp, "\t%d\t*\t0\t0\t*\t*\t0\t0\t", flags);
      if (p->cs) {
        memcpy(wp, "*\t*", 3);
        wp += 3;
        memcpy(wp, "\tCQ:Z:", 6);
        wp += 6;
        if (p->cs_fastq && p->cs_cq) {
          memcpy(wp, p->cs_cq + (int64_t)ri * p->cs_cq_len,
                 p->cs_cq_len);
          wp += p->cs_cq_len;
        } else {
          *wp++ = '*';
        }
        memcpy(wp, "\tCS:Z:", 6);
        wp += 6;
        memcpy(wp, p->cs_readseq + (int64_t)ri * p->cs_read_seq_len,
               p->cs_read_seq_len);
        wp += p->cs_read_seq_len;
      } else {
        memcpy(wp, p->seq_fwd + ri * R, R);
        wp += R;
        *wp++ = '\t';
        if (p->qual_raw) {
          memcpy(wp, p->qual_raw + ri * R, R);
          wp += R;
        } else {
          *wp++ = '*';
        }
      }
      if (p->sam_r2) {
        if (p->cs) {
          memcpy(wp, "\tX2:Z:", 6);
          wp += 6;
          memcpy(wp, p->cs_readseq + ri_mp * p->cs_read_seq_len,
                 p->cs_read_seq_len);
          wp += p->cs_read_seq_len;
        } else {
          memcpy(wp, "\tR2:Z:", 6);
          wp += 6;
          memcpy(wp, p->seq_raw + ri_mp * R, R);
          wp += R;
        }
      }
      if (p->rg_len) {
        memcpy(wp, p->rg, p->rg_len);
        wp += p->rg_len;
      }
      *wp++ = '\n';
      return true;
    };

    bool any_out = !pairs.empty();
    for (auto& c : pairs) {
      int q0 = foot_index(0, c.r0), q1 = foot_index(1, c.r1);
      int m0 = p->compute_mqv ? pr_mqv[0][q0] : 255;
      int m1 = p->compute_mqv ? pr_mqv[1][q1] : 255;
      if (!emit_line(0, c.r0, c.r1, true, m0, ft_z2[0][q0], z3, pr2_pre,
                     ins_denom, true))
        return -1;
      if (!emit_line(1, c.r1, c.r0, true, m1, ft_z2[1][q1], z3, pr2_pre,
                     ins_denom, true))
        return -1;
    }
    if (p->compute_mqv) {
      double denom = 0.0;
      if (!hp_out[0].empty()) denom += pr_top[1] * pr_top[2] * prm;
      if (!hp_out[1].empty()) denom += pr_top[0] * pr_top[2] * prm;
      if (!pairs.empty()) denom += pr_top[0] * pr_top[1];
      for (int nip = 0; nip < 2; nip++) {
        for (size_t q = 0; q < hp_out[nip].size(); q++) {
          int32_t t = hp_out[nip][q];
          any_out = true;
          double pc = (pr_top[1 - nip] * pr_top[2] * prm / denom) *
                      (S.post[t] / up_z1[nip]);
          int m = pp_qv_from_pr_corr(pc);
          if (m < 4) m = 0;
          // render_pair_entry order: the leg0 line always precedes the
          // leg1 line, whichever of the two is the unmapped mate
          if (nip == 0) {
            if (!emit_line(0, t, -1, false, m, S.post[t], up_z1[0],
                           up_z4[0], prm, false))
              return -1;
            if (!emit_unmapped(1, t)) return -1;
          } else {
            if (!emit_unmapped(0, t)) return -1;
            if (!emit_line(1, t, -1, false, m, S.post[t], up_z1[1],
                           up_z4[1], prm, false))
              return -1;
          }
        }
      }
    }
    if (p->sam_unaligned && !any_out &&
        pi >= p->una_lo && pi < p->una_hi) {
      if (!emit_unaligned(0)) return -1;
      if (!emit_unaligned(1)) return -1;
    }
  }
  if (p->select_only) return nsel;
  return wp - out_buf;
}

}  // extern "C"
