// Shared colour-space hit evaluation: one full-SW result (packed row +
// reverse step string) -> post-SW rescoring + render strings.
//
// Used by cspipe.cpp (unpaired CS fast path) and pairedpipe.cpp (CS
// paired mode). Mirrors sw-post.c:472-757 exactly (columns via the
// step walk instead of dbalign/qralign strings) and the CS flavour of
// hit_output (SEQ = called letters, CIGAR runs, XX/CM).

#ifndef SHRIMP_TPU_CS_EVAL_H
#define SHRIMP_TPU_CS_EVAL_H

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" void cs_fb_one(
    const int64_t *cols_let, const int64_t *cols_col,
    const double *cols_err, int64_t n, int init_bp,
    double la_match, double la_mis, double pr_snp,
    double *fw, double *bw, double *pri, double *fwscale,
    double *bwscale, double *total_out, double *post_out);

namespace cseval {

static const char LS_CHARS_[17] = "ACGTUMRWSYKVHDBN";
static const int BASE_N_ = 15;

// util.h:284-293
inline double pr_err_from_qv(int qv) {
  if (qv <= 0) return .99999999;
  if (qv >= 250) return 1e-25;
  return pow(10.0, -qv / 10.0);
}

inline int qv_from_pr_corr(double pr_corr) {
  double pr_err = 1.0 - pr_corr;
  if (pr_err > .99999999) return 0;
  if (pr_err < 1e-25) return 250;
  return (int)(-10.0 * log(pr_err) / log(10.0));
}

// batch-constant context
struct Ctx {
  const uint8_t* genome_fwd;
  const uint8_t* genome_rc;
  const uint8_t* colours;    // [n_reads, R]
  const uint8_t* qr_tab;     // [n_reads, 4, R]
  const int32_t* initbp;     // [n_reads]
  const uint8_t* quals;      // [n_reads, R] scoring quals or null
  int R;
  int steps_words;
  double alpha, beta;
  double pr_xover, pr_snp;
  double pr_del_open, pr_del_extend, pr_ins_open, pr_ins_extend;
  int qual_delta;
  int use_sanger_qvs;
  bool use_read_qvs;
  bool want_qual;            // compute the post-SW QUAL string
  double la_match, la_mis;   // log(1-pr_snp), log(pr_snp/3)
};

// per-call scratch, reusable across hits
struct Scratch {
  std::vector<int64_t> cols_let, cols_col;
  std::vector<double> cols_err;
  std::vector<int32_t> col_db, base_call;
  std::vector<int8_t> step_op;
  std::vector<int32_t> step_col;
  std::vector<double> fb_fw, fb_bw, fb_pri, fb_fws, fb_bws, fb_post;

  void ensure(int maxcols, int W) {
    if ((int)cols_let.size() < maxcols) {
      cols_let.resize(maxcols);
      cols_col.resize(maxcols);
      cols_err.resize(maxcols);
      col_db.resize(maxcols);
      base_call.resize(maxcols);
      fb_fw.resize((size_t)maxcols * 16);
      fb_bw.resize((size_t)maxcols * 16);
      fb_pri.resize((size_t)maxcols * 16);
      fb_fws.resize(maxcols);
      fb_bws.resize(maxcols);
      fb_post.resize((size_t)maxcols * 4);
    }
    if ((int)step_op.size() < W + 1) {
      step_op.resize(W + 1);
      step_col.resize(W + 1);
    }
  }
};

struct Result {
  double posterior = 0.0;
  long ps = 0;               // posterior_score
  int rmapped = 0, gmapped = 0;
  int ins = 0, dele = 0;     // genome-only / read-only step counts
  int rs = 0;                // read_start
  int matches = 0, mismatches = 0, crossovers = 0;
  std::vector<uint8_t> xx;   // rewritten qralign incl '-' and case
  std::vector<uint8_t> seq;  // called letters, fwd order, upper
  std::vector<uint8_t> qual; // post-SW base qualities (want_qual)
  std::vector<int32_t> cig_n;
  std::vector<char> cig_c;
};

// Evaluate one hit. pk: the 12-int16 packed row; steps: reverse-order
// step string; gbase: absolute plane offset of the (normalized)
// window; gen_st_rc selects the genome plane. Returns false when the
// DP score is 0 / no columns (hit contributes nothing).
inline bool eval_hit(const Ctx& c, Scratch& sc, int64_t ri,
                     const int16_t* pk, const int8_t* steps,
                     int64_t gbase, bool gen_st_rc, Result& out) {
  const int R = c.R;
  const int W = c.steps_words;
  sc.ensure(W + 4, W);
  int score = pk[0];
  if (score <= 0) return false;
  const int nops = pk[4];
  const int rs = pk[5], gs = pk[6];
  const int ins = pk[9], dele = pk[10];
  const uint8_t* genome = gen_st_rc ? c.genome_rc : c.genome_fwd;
  const uint8_t* rcol = c.colours + ri * R;
  const uint8_t* qr = c.qr_tab + ri * 4 * R;
  const int init_bp = c.initbp[ri];
  const uint8_t* rqual =
      (c.use_read_qvs && c.quals) ? c.quals + ri * R : nullptr;

  // ---- column extraction (load_local_vectors, sw-post.c:472-551)
  int start_run = 0;
  int min_qv = 10000;
  for (int q = 0; q < rs; q++) {
    int cc = rcol[q];
    if (cc == BASE_N_) { start_run = BASE_N_; min_qv = 0; break; }
    start_run ^= cc;
    if (rqual && (int)rqual[q] < min_qv) min_qv = rqual[q];
  }
  int ncol = 0;
  {
    int ii = rs, jj = gs;
    int nst = 0;
    for (int q = nops - 1; q >= 0; q--) {
      int s = steps[q];
      int op = s & 3;
      sc.step_op[nst] = (int8_t)op;
      if (op == 1) {                 // genome-only: qralign '-'
        sc.step_col[nst++] = -1;
        jj++;
        continue;
      }
      int gl = -1;
      if (op == 3) gl = genome[gbase + jj];
      sc.cols_let[ncol] = (op == 3) ? (int64_t)gl : (int64_t)-1;
      sc.col_db[ncol] = (op == 3) ? gl : -1;
      {
        int lay = (s >> 2) & 3;
        int bc = qr[lay * R + ii];
        if (op == 3 && bc == BASE_N_) bc = gl;
        sc.base_call[ncol] = bc;
      }
      int cc = rcol[ii];
      if ((ncol == 0 && start_run == BASE_N_) || cc == BASE_N_) {
        sc.cols_col[ncol] = 0;
        sc.cols_err[ncol] = .75;
      } else {
        sc.cols_col[ncol] = cc ^ (ncol == 0 ? start_run : 0);
        if (rqual) {
          int qch = rqual[ii];
          if (ncol == 0 && min_qv < qch) qch = min_qv;
          double err = pr_err_from_qv(qch - c.qual_delta);
          if (!c.use_sanger_qvs) err = err / (1 + err);
          if (err > .75) err = .75;
          sc.cols_err[ncol] = err;
        } else {
          sc.cols_err[ncol] = c.pr_xover;
        }
      }
      sc.step_col[nst++] = ncol;
      ncol++;
      ii++;
      if (op == 3) jj++;
    }
  }
  if (ncol == 0) return false;

  // ---- forward-backward (cs_fb_one mirrors sw-post.c exactly)
  double total;
  cs_fb_one(sc.cols_let.data(), sc.cols_col.data(), sc.cols_err.data(),
            ncol, init_bp, c.la_match, c.la_mis, c.pr_snp,
            sc.fb_fw.data(), sc.fb_bw.data(), sc.fb_pri.data(),
            sc.fb_fws.data(), sc.fb_bws.data(), &total,
            sc.fb_post.data());

  // ---- fix_base_calls (sw-post.c:554-590)
  out.xx.resize(nops);
  out.seq.resize(ncol);
  int matches = 0, mismatches = 0, crossovers = 0;
  {
    int prev = init_bp;
    for (int st = 0; st < nops; st++) {
      int ci = sc.step_col[st];
      if (ci < 0) { out.xx[st] = '-'; continue; }
      const double* po = sc.fb_post.data() + (int64_t)ci * 4;
      int crt = 0;
      for (int q = 1; q < 4; q++)
        if (po[q] > po[crt]) crt = q;
      char ch;
      if ((prev ^ crt) == (int)sc.cols_col[ci]) {
        ch = LS_CHARS_[crt];
      } else {
        ch = (char)(LS_CHARS_[crt] + 32);
        crossovers++;
      }
      out.xx[st] = (uint8_t)ch;
      out.seq[ci] = (uint8_t)LS_CHARS_[crt];
      if (sc.col_db[ci] >= 0) {
        if (sc.col_db[ci] == crt) matches++; else mismatches++;
      }
      prev = crt;
    }
  }

  // ---- get_base_qualities (sw-post.c:591-609)
  if (c.want_qual) {
    out.qual.resize(ncol);
    for (int k = 0; k < ncol; k++) {
      int bc = sc.base_call[k];
      int tmp = 0;
      if (bc != BASE_N_ && bc <= 3)
        tmp = qv_from_pr_corr(sc.fb_post[(int64_t)k * 4 + bc]);
      if (tmp > 40) tmp = 40;
      out.qual[k] = (uint8_t)(33 + tmp);
    }
  } else {
    out.qual.clear();
  }

  // ---- get_posterior (sw-post.c:611-633)
  double res = exp(-total);
  for (int st = 0; st < nops; st++) {
    if (sc.step_op[st] == 2) {
      res *= c.pr_ins_extend;
      if (st == 0 || sc.step_op[st - 1] != 2) res *= c.pr_ins_open;
    } else if (sc.step_op[st] == 1) {
      res *= c.pr_del_extend;
      if (st == 0 || sc.step_op[st - 1] != 1) res *= c.pr_del_open;
    }
  }

  const int rmapped = nops - ins;
  double cc2 = 2.0 * c.alpha + c.beta;
  double psd = c.alpha * log2(res) + (double)rmapped * cc2;
  long ps = (long)nearbyint(psd);  // Python round() = half-even
  if (ps < 0) ps = 0;

  out.posterior = res;
  out.ps = ps;
  out.rmapped = rmapped;
  out.gmapped = nops - dele;
  out.ins = ins;
  out.dele = dele;
  out.rs = rs;
  out.matches = matches;
  out.mismatches = mismatches;
  out.crossovers = crossovers;

  // ---- CIGAR runs (make_cigar output.c:15-64, S->H for CS
  // output.c:575-579), forward order
  out.cig_n.clear();
  out.cig_c.clear();
  if (rs > 0) { out.cig_n.push_back(rs); out.cig_c.push_back('H'); }
  int prevop = -1, cnt = 0;
  for (int st = 0; st < nops; st++) {
    int op = sc.step_op[st];
    if (op == prevop) { cnt++; continue; }
    if (cnt) {
      out.cig_n.push_back(cnt);
      out.cig_c.push_back(prevop == 2 ? 'I' : (prevop == 1 ? 'D' : 'M'));
    }
    prevop = op;
    cnt = 1;
  }
  if (cnt) {
    out.cig_n.push_back(cnt);
    out.cig_c.push_back(prevop == 2 ? 'I' : (prevop == 1 ? 'D' : 'M'));
  }
  int read_end1 = rs + rmapped;
  if (read_end1 != R) {
    out.cig_n.push_back(R - read_end1);
    out.cig_c.push_back('H');
  }
  return true;
}

}  // namespace cseval

#endif  // SHRIMP_TPU_CS_EVAL_H
