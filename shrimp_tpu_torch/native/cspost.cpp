// Colour-space post-SW forward-backward (common/sw-post.c:271-438),
// batched over alignments and threaded over the batch.
//
// Bit-faithful port of the reference scalar code: every floating-point
// operation happens in the same order with the same libm calls
// (do_forwards / do_backwards / post_traceback, sw-post.c:271-374,
// 185-210).  The numpy formulation in core/sw_cs_batch.py restructures
// the sums through numpy's pairwise/SIMD reductions, which differ from
// libm by ~1 ulp; this implementation is the exact oracle order, so its
// quantized outputs (QVs, tnlog Z fields) match gmapper's.
//
// Compile flags must include -ffp-contract=off (see native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
inline int left16(int j) { return (j >> 2) & 3; }
inline int right16(int j) { return j & 3; }
} // namespace

// One alignment's forward-backward.  cols_let: -1 = no letter emission
// (read-only insertion column).  Outputs total (forward score) and
// post[n][4] posteriors.  Shared with cspipe.cpp (the colour-space
// native finalize path); scratch buffers are caller-provided.
extern "C" void cs_fb_one(
    const int64_t *cols_let, const int64_t *cols_col,
    const double *cols_err, int64_t n, int init_bp,
    double la_match, double la_mis, double pr_snp,
    double *fw, double *bw, double *pri, double *fwscale,
    double *bwscale, double *total_out, double *post_out) {
  (void)pr_snp;
  // node priors (nodePrior, sw-post.c:113-139): letter term then colour
  // term, each val -= log(...) in sequence
  for (int64_t i = 0; i < n; i++) {
    const double err = cols_err[i];
    const double lb_match = log(1 - err);
    const double lb_mis = log(err / 3.0);
    const int let = (int)cols_let[i];
    const int col = (int)cols_col[i];
    double *p = pri + i * 16;
    for (int j = 0; j < 16; j++) {
      double val = 0.0;
      if (let >= 0)
        val = val - (right16(j) == let ? la_match : la_mis);
      val = val - ((left16(j) ^ right16(j)) == col ? lb_match : lb_mis);
      p[j] = val;
    }
  }

  // do_forwards (sw-post.c:321-364)
  {
    double scale = 999999999.0;
    double *f0 = fw;
    for (int j = 0; j < 16; j++) {
      if (left16(j) == init_bp) {
        f0[j] = pri[j];
        scale = scale < f0[j] ? scale : f0[j];
      } else {
        f0[j] = HUGE_VAL;
      }
    }
    for (int j = 0; j < 16; j++)
      f0[j] -= scale;
    fwscale[0] = scale;
  }
  for (int64_t i = 1; i < n; i++) {
    const double *fp = fw + (i - 1) * 16;
    double *fc = fw + i * 16;
    const double *p = pri + i * 16;
    double E[16];
    for (int k = 0; k < 16; k++)
      E[k] = exp(-1 * (fp[k]));
    // S[c] = sum over k with right(k)==c, k ascending — the reference
    // accumulates sequentially (sw-post.c:345-349)
    double S[4];
    for (int c = 0; c < 4; c++) {
      double s = 0.0;
      s += E[c];
      s += E[4 + c];
      s += E[8 + c];
      s += E[12 + c];
      S[c] = s;
    }
    double scale = 999999999.0;
    for (int j = 0; j < 16; j++) {
      fc[j] = p[j] - log(S[left16(j)]);
      scale = scale < fc[j] ? scale : fc[j];
    }
    for (int j = 0; j < 16; j++)
      fc[j] -= scale;
    fwscale[i] = scale + fwscale[i - 1];
  }
  double total;
  {
    double val = 0.0;
    const double *fl = fw + (n - 1) * 16;
    for (int j = 0; j < 16; j++)
      val += exp(-1 * (fl[j]));
    total = -log(val) + fwscale[n - 1];
  }
  *total_out = total;

  // do_backwards (sw-post.c:271-319)
  {
    double *bl = bw + (n - 1) * 16;
    for (int j = 0; j < 16; j++)
      bl[j] = 0.0;
    bwscale[n - 1] = 0.0; // MIN2(999999999, 0) subtracted from zeros
  }
  for (int64_t i = n - 2; i >= 0; i--) {
    const double *bn = bw + (i + 1) * 16;
    double *bc = bw + i * 16;
    const double *pn = pri + (i + 1) * 16;
    double E2[16];
    for (int k = 0; k < 16; k++)
      E2[k] = exp(-1 * (pn[k] + bn[k]));
    double scale = 999999999.0;
    for (int j = 0; j < 16; j++) {
      // k with right(j)==left(k): k = 4*right(j)+m, m ascending
      const int c = right16(j);
      double s = 0.0;
      s += E2[4 * c + 0];
      s += E2[4 * c + 1];
      s += E2[4 * c + 2];
      s += E2[4 * c + 3];
      bc[j] = -log(s);
      scale = scale < bc[j] ? scale : bc[j];
    }
    for (int j = 0; j < 16; j++)
      bc[j] -= scale;
    bwscale[i] = scale + bwscale[i + 1];
  }

  // post_traceback posterior accumulation (sw-post.c:185-210); argmax
  // is left to the caller
  for (int64_t i = 0; i < n; i++) {
    double *po = post_out + i * 4;
    po[0] = po[1] = po[2] = po[3] = 0.0;
    const double *fc = fw + i * 16;
    const double *bc = bw + i * 16;
    const double fs = fwscale[i];
    const double bs = bwscale[i];
    for (int j = 0; j < 16; j++)
      po[right16(j)] +=
          exp(-1 * (fc[j] + bc[j] + fs + bs - total));
  }
}

extern "C" int64_t cs_post_fb_batch(
    int64_t B, int64_t L, const int64_t *cols_let, const int64_t *cols_col,
    const double *cols_err, const int64_t *ncols, const int64_t *initbp,
    double pr_snp, double *total_out, double *post_out, int32_t nthreads) {
  if (B <= 0)
    return 0;
  const double la_match = log(1 - pr_snp);
  const double la_mis = log(pr_snp / 3.0);
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0)
      nthreads = 1;
  }
  if (nthreads > B)
    nthreads = (int32_t)B;

  auto work = [&](int64_t b0, int64_t b1) {
    std::vector<double> fw, bw, pri, fwscale, bwscale;
    for (int64_t b = b0; b < b1; b++) {
      int64_t n = ncols[b];
      if (n <= 0) {
        total_out[b] = 0.0;
        continue;
      }
      if ((int64_t)fwscale.size() < n) {
        fw.resize(n * 16);
        bw.resize(n * 16);
        pri.resize(n * 16);
        fwscale.resize(n);
        bwscale.resize(n);
      }
      cs_fb_one(cols_let + b * L, cols_col + b * L, cols_err + b * L, n,
                (int)initbp[b], la_match, la_mis, pr_snp, fw.data(),
                bw.data(), pri.data(), fwscale.data(), bwscale.data(),
                &total_out[b], post_out + b * L * 4);
    }
  };
  if (nthreads == 1) {
    work(0, B);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (B + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int64_t b0 = t * per, b1 = b0 + per < B ? b0 + per : B;
      if (b0 >= b1)
        break;
      ts.emplace_back(work, b0, b1);
    }
    for (auto &t : ts)
      t.join();
  }
  return 0;
}
