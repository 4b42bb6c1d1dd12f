// Native colour-space unpaired finalize + render.
//
// Consumes the flat outputs of the fused CS device launch (vector
// scores already consumed by pass1_select; here: the 4-layer full-SW
// packed rows + reverse-order step strings of the SELECTED hits) and
// performs, per read, the whole remaining gmapper pipeline:
//
//   post-SW rescoring      sw-post.c:639-757  (cs_eval.h / cspost.cpp)
//   read_pass2 filtering   mapping.c:1631-1750, 1520-1606
//   unpaired MQVs          gmapper/output.c:777-793
//   SAM line assembly      hit_output, output.c:227-774 (CS flavour:
//                          SEQ = called letters, S->H clips, CS/CM/XX)
//
// Selections, numbers and SAM bytes are identical to the Python
// generic path (mapper._pass2_cs + _finalize + io/sam.py), which is
// itself golden-tested against gmapper-cs.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

#include "cs_eval.h"

extern "C" {

struct CSFRParams {
  int64_t n_jobs;
  int64_t n_reads;
  int32_t read_len;       // R: colour count per read
  int32_t steps_words;    // columns of steps_rev
  int32_t read_seq_len;   // raw read string length (primer + colours)
  double sw_full_threshold;   // negative = absolute
  int32_t num_outputs;
  int32_t strata;
  int32_t max_alignments;
  int32_t single_best;
  int32_t compute_mqv;
  double alpha, beta;
  double pr_xover, pr_snp;
  double pr_del_open, pr_del_extend, pr_ins_open, pr_ins_extend;
  int64_t genome_len;
  const uint8_t* genome_fwd;   // letter planes (padded)
  const uint8_t* genome_rc;
  const uint32_t* contig_lengths;
  const int32_t* contig_name_off;
  const char* contig_names;
  const int64_t* name_off;     // [n_reads + 1]
  const char* names;
  const uint8_t* colours;      // [n_reads, R] colour codes, input strand
  const uint8_t* qr_tab;       // [n_reads, 4, R] letter layers
  const int32_t* initbp;       // [n_reads]
  const uint8_t* readseq;      // [n_reads, read_seq_len] raw chars
  // fastq extras (null quals -> quality-less flow)
  int32_t fastq;               // emit QUAL column + CQ:Z
  int32_t use_read_qvs;        // quals drive colour error rates
  int32_t qual_delta;
  int32_t use_sanger_qvs;
  const uint8_t* quals;        // [n_reads, R] scoring quality chars
  const uint8_t* cq;           // [n_reads, cq_len] raw chars for CQ:Z
  int32_t cq_len;
  // renderer-level flags (must not evict the device fast path)
  const char* rg;              // "\tRG:Z:<name>" suffix or null
  int32_t rg_len;
  int32_t all_contigs;         // omit Z fields
  int32_t sam_unaligned;       // emit flag-4 records for unmapped
};

struct CSFRJobs {
  const int32_t* ri;
  const int32_t* cn;
  const int8_t* gen_st;
  const int64_t* g_off;       // normalized contig-local window start
  const int64_t* start_abs;   // normalized absolute plane offset
  const int64_t* score_max;
  const int16_t* packed;      // [n, 12] score bi bj bk nops rs gs m mm
                              //          ins dele xo
  const int8_t* steps_rev;    // [n, steps_words] op|lay<<2|xov<<4, rev
};

struct CSHit {
  int64_t job;
  int64_t key;
  int32_t score_full;
  int64_t gstart;          // contig-local alignment start
  int order;
  cseval::Result ev;
  int mqv;
  int64_t k1[3], k2[3];
};

int64_t cs_finalize_render(const CSFRParams* p, const CSFRJobs* j,
                           char* out_buf, int64_t out_cap,
                           int32_t* read_nhits) {
  const bool absolute = p->sw_full_threshold < 0;
  const double thr_pct = p->sw_full_threshold / 100.0;
  const int R = p->read_len;
  char* w = out_buf;
  char* end = out_buf + out_cap;

  for (int64_t r = 0; r < p->n_reads; r++) read_nhits[r] = 0;
  if (!p->compute_mqv) return -2;

  cseval::Ctx ctx;
  ctx.genome_fwd = p->genome_fwd;
  ctx.genome_rc = p->genome_rc;
  ctx.colours = p->colours;
  ctx.qr_tab = p->qr_tab;
  ctx.initbp = p->initbp;
  ctx.quals = p->quals;
  ctx.R = R;
  ctx.steps_words = p->steps_words;
  ctx.alpha = p->alpha;
  ctx.beta = p->beta;
  ctx.pr_xover = p->pr_xover;
  ctx.pr_snp = p->pr_snp;
  ctx.pr_del_open = p->pr_del_open;
  ctx.pr_del_extend = p->pr_del_extend;
  ctx.pr_ins_open = p->pr_ins_open;
  ctx.pr_ins_extend = p->pr_ins_extend;
  ctx.qual_delta = p->qual_delta;
  ctx.use_sanger_qvs = p->use_sanger_qvs;
  ctx.use_read_qvs = p->use_read_qvs != 0;
  ctx.want_qual = p->fastq != 0;
  ctx.la_match = log(1 - p->pr_snp);
  ctx.la_mis = log(p->pr_snp / 3.0);
  cseval::Scratch sc;
  std::vector<CSHit> sv;
  sv.reserve(32);

  // CS unmapped record (render_hit unmapped branch): SEQ/QUAL are '*',
  // CQ:Z raw quals (or '*'), CS:Z the raw colour read, then RG
  auto emit_unmapped = [&](int64_t ri) -> bool {
    int64_t nl = p->name_off[ri + 1] - p->name_off[ri];
    if (end - w < 64 + nl + p->read_seq_len + p->cq_len + p->rg_len)
      return false;
    memcpy(w, p->names + p->name_off[ri], nl);
    w += nl;
    memcpy(w, "\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\tCQ:Z:", 26);
    w += 26;
    if (p->fastq && p->cq) {
      memcpy(w, p->cq + (int64_t)ri * p->cq_len, p->cq_len);
      w += p->cq_len;
    } else {
      *w++ = '*';
    }
    memcpy(w, "\tCS:Z:", 6);
    w += 6;
    memcpy(w, p->readseq + ri * p->read_seq_len, p->read_seq_len);
    w += p->read_seq_len;
    if (p->rg_len) {
      memcpy(w, p->rg, p->rg_len);
      w += p->rg_len;
    }
    *w++ = '\n';
    return true;
  };

  int64_t a = 0;
  for (int64_t ri = 0; ri < p->n_reads; ri++) {
    int64_t b = a;
    while (b < p->n_jobs && j->ri[b] < ri) b++;   // (defensive)
    a = b;
    while (b < p->n_jobs && j->ri[b] == ri) b++;

    sv.clear();
    for (int64_t t = a; t < b; t++) {
      const int16_t* pk = j->packed + t * 12;
      CSHit h;
      if (!cseval::eval_hit(ctx, sc, ri, pk,
                            j->steps_rev + t * p->steps_words,
                            j->start_abs[t], j->gen_st[t] != 0, h.ev))
        continue;
      long ps = h.ev.ps;
      int64_t smax = j->score_max[t];
      double thresh = absolute ? -p->sw_full_threshold
                               : thr_pct * (double)smax;
      if ((double)ps < thresh) continue;
      h.job = t;
      h.score_full = (int32_t)ps;
      h.key = absolute ? ps : (1000LL * 100LL * ps) / smax;
      h.order = (int)(t - a);
      h.gstart = (int64_t)pk[6] + j->g_off[t];
      h.k1[0] = j->cn[t]; h.k1[1] = j->gen_st[t]; h.k1[2] = h.gstart;
      h.k2[0] = j->cn[t]; h.k2[1] = j->gen_st[t];
      h.k2[2] = -h.gstart - h.ev.rmapped + h.ev.dele - h.ev.ins;
      sv.push_back(std::move(h));
    }

    if (sv.size() > 1) {
      for (int pass = 0; pass < 2; pass++) {
        std::stable_sort(sv.begin(), sv.end(),
                         [pass](const CSHit& x, const CSHit& y) {
          const int64_t* kx = pass ? x.k2 : x.k1;
          const int64_t* ky = pass ? y.k2 : y.k1;
          if (kx[0] != ky[0]) return kx[0] < ky[0];
          if (kx[1] != ky[1]) return kx[1] < ky[1];
          return kx[2] < ky[2];
        });
        std::vector<CSHit> outv;
        size_t i = 0;
        while (i < sv.size()) {
          size_t g = i, best = i;
          auto eq = [pass](const CSHit& x, const CSHit& y) {
            const int64_t* kx = pass ? x.k2 : x.k1;
            const int64_t* ky = pass ? y.k2 : y.k1;
            return kx[0] == ky[0] && kx[1] == ky[1] && kx[2] == ky[2];
          };
          while (g + 1 < sv.size() && eq(sv[g + 1], sv[i])) {
            g++;
            if (sv[g].key > sv[best].key) best = g;
          }
          outv.push_back(std::move(sv[best]));
          i = g + 1;
        }
        sv.swap(outv);
      }
      std::stable_sort(sv.begin(), sv.end(),
                       [](const CSHit& x, const CSHit& y) {
                         return x.key > y.key;
                       });
    }
    if ((int64_t)sv.size() > p->num_outputs) sv.resize(p->num_outputs);
    if (p->strata && !sv.empty()) {
      size_t i = 1;
      while (i < sv.size() && sv[0].score_full == sv[i].score_full) i++;
      sv.resize(i);
    }
    if (p->max_alignments > 0 && (int64_t)sv.size() > p->max_alignments)
      sv.clear();

    if (!sv.empty()) {
      double z1 = 0.0;
      for (auto& s : sv) z1 += s.ev.posterior;
      for (auto& s : sv) {
        s.mqv = cseval::qv_from_pr_corr(s.ev.posterior / z1);
        if (s.mqv < 4) s.mqv = 0;
      }
      if (p->single_best && sv.size() > 1) {
        size_t best = 0;
        for (size_t i = 1; i < sv.size(); i++)
          if (sv[i].mqv > sv[best].mqv) best = i;
        CSHit b2 = std::move(sv[best]);
        sv.clear();
        sv.push_back(std::move(b2));
      }
      for (auto& s : sv) {
        int64_t t = s.job;
        bool rev = j->gen_st[t] != 0;
        const cseval::Result& ev = s.ev;
        int read_end1 = ev.rs + ev.rmapped;
        int64_t glen_c = (int64_t)p->contig_lengths[j->cn[t]];
        int64_t pos;
        if (!rev) {
          pos = s.gstart + 1;
        } else {
          int64_t right = glen_c - s.gstart;
          pos = right - (read_end1 - (ev.rs + 1) - ev.dele + ev.ins);
        }
        int64_t nl = p->name_off[ri + 1] - p->name_off[ri];
        int64_t need = 512 + nl + (int64_t)ev.xx.size() + ev.seq.size()
                       + ev.qual.size() + (int64_t)p->read_seq_len
                       + p->cq_len + p->rg_len
                       + 12 * (int64_t)ev.cig_n.size();
        if (end - w < need) return -1;
        memcpy(w, p->names + p->name_off[ri], nl);
        w += nl;
        w += sprintf(w, "\t%d\t", rev ? 0x10 : 0);
        int32_t cn = j->cn[t];
        int32_t cl = p->contig_name_off[cn + 1] - p->contig_name_off[cn];
        memcpy(w, p->contig_names + p->contig_name_off[cn], cl);
        w += cl;
        w += sprintf(w, "\t%lld\t%d\t", (long long)pos, s.mqv);
        if (!rev) {
          for (size_t q = 0; q < ev.cig_n.size(); q++)
            w += sprintf(w, "%d%c", ev.cig_n[q], ev.cig_c[q]);
        } else {
          for (size_t q = ev.cig_n.size(); q-- > 0;)
            w += sprintf(w, "%d%c", ev.cig_n[q], ev.cig_c[q]);
        }
        memcpy(w, "\t*\t0\t0\t", 7);
        w += 7;
        // SEQ: called letters; revcomp on the reverse strand
        if (!rev) {
          memcpy(w, ev.seq.data(), ev.seq.size());
          w += ev.seq.size();
        } else {
          static const char comp[5] = "TGCA";
          for (size_t q = ev.seq.size(); q-- > 0;) {
            uint8_t c = ev.seq[q];
            int code = (c == 'A') ? 0 : (c == 'C') ? 1
                       : (c == 'G') ? 2 : 3;
            *w++ = comp[code];
          }
        }
        *w++ = '\t';
        if (p->fastq && !ev.qual.empty()) {
          // post-SW base qualities, strand-oriented (output.c:613-622)
          if (!rev) {
            memcpy(w, ev.qual.data(), ev.qual.size());
            w += ev.qual.size();
          } else {
            for (size_t q = ev.qual.size(); q-- > 0;)
              *w++ = (char)ev.qual[q];
          }
        } else {
          *w++ = '*';
        }
        w += sprintf(w, "\tAS:i:%d", s.score_full);
        if (!p->all_contigs)
          w += sprintf(w, "\tZ0:i:%d\tZ1:i:%d",
                       (int)(1000.0 * -log(s.ev.posterior)),
                       (int)(1000.0 * -log(z1)));
        w += sprintf(w, "\tNM:i:%d", ev.mismatches + ev.dele + ev.ins);
        if (p->fastq && p->cq) {
          // CQ:Z raw colour quality string (output.c:688-690)
          memcpy(w, "\tCQ:Z:", 6);
          w += 6;
          memcpy(w, p->cq + (int64_t)ri * p->cq_len, p->cq_len);
          w += p->cq_len;
        }
        // CS:Z raw read, CM:i crossovers, XX:Z rewritten qralign
        memcpy(w, "\tCS:Z:", 6);
        w += 6;
        memcpy(w, p->readseq + ri * p->read_seq_len, p->read_seq_len);
        w += p->read_seq_len;
        w += sprintf(w, "\tCM:i:%d", ev.crossovers);
        memcpy(w, "\tXX:Z:", 6);
        w += 6;
        memcpy(w, ev.xx.data(), ev.xx.size());
        w += ev.xx.size();
        if (p->rg_len) {
          memcpy(w, p->rg, p->rg_len);
          w += p->rg_len;
        }
        *w++ = '\n';
      }
      read_nhits[ri] = (int32_t)sv.size();
    }
    if (p->sam_unaligned && read_nhits[ri] == 0) {
      if (!emit_unmapped(ri)) return -1;
    }
    a = b;
  }
  return w - out_buf;
}

}  // extern "C"
