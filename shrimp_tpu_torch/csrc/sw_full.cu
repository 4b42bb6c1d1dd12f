// Traceback-free full Smith-Waterman (filter 3 stats), hand-written for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel shrimp_tpu/core/sw_full_pallas.py::
// _kernel with emit_bp=False, reached through sw_full_stats_pallas
// (including its _plane_from_stats epilogue). The banded 3-plane
// (NW, N, W) affine DP, global or local, with the revcmpl tie-break
// flip, the band-left W injection and the out-of-band reset to each
// mode's init values on every row; it tracks the best cell (strict >
// across rows, smallest j within a row) and the diagonal-chain run,
// term, deq and base. Output rows are bit-equal to sw_full_stats_pallas:
// [B, 8] int32 = score, max_i, max_j, plane, run, term, deq, base.
//
// What bounds it on an H100: integer ALU. A cell costs a few dozen
// int32 operations (three planes, the chain carries, the row maximum)
// over B*R*G cells, while device memory supplies only the window and
// read bytes of each pair; the per-thread row planes stay in L1.
//
// What the simple design does about it: one thread per (window, read)
// pair. The thread walks rows i and columns j in order, so the W-gap
// chain (a log-doubling cummax on the TPU) is a scalar running max
// carried along j, and the row's best cell is a scalar compare. The
// previous row's seven planes (nw, n, w, run, term, deq, base) live in
// per-thread arrays of G+1 ints sized by the G bucket (a template
// parameter), in local memory, updated in place with the diagonal
// values held in registers. Rows i >= rlen can never be recorded, so
// the row loop stops at rlen.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
constexpr int BLOCK = 64;
// NW-plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
constexpr int NW_FROM_NW = 1, NW_FROM_N = 2, NW_FROM_W = 3;

template <int GMAX>
__global__ void __launch_bounds__(BLOCK)
sw_full_stats_kernel(const uint8_t* __restrict__ genome,
                     const int32_t* __restrict__ glen,
                     const uint8_t* __restrict__ read,
                     const int32_t* __restrict__ rlen,
                     const int32_t* __restrict__ ax_,
                     const int32_t* __restrict__ ay_,
                     const int32_t* __restrict__ alen_,
                     const int32_t* __restrict__ awid_,
                     const int32_t* __restrict__ rev,
                     int32_t* __restrict__ out, int B, int G, int R, int m,
                     int mm, int goa, int gea, int gob, int geb, int local) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* r = read + (size_t)b * R;
  const int gl = glen[b], rl = rlen[b];
  const int ax = ax_[b], ay = ay_[b], alen = alen_[b], awid = awid_[b];
  const bool rv = rev[b] != 0;
  // out-of-band resting values and the pad column j = -1 of rows >= 0
  const int init_nw = local ? 0 : NEG;
  const int init_n = local ? -gob : NEG;   // == b_gap_open
  const int init_w = local ? -goa : NEG;   // == a_gap_open

  // previous row, index j + 1 for column j (index 0 is the pad column);
  // row -1 is nw = 0, n = b_gap_open, w = a_gap_open in both modes
  int p_nw[GMAX + 1], p_n[GMAX + 1], p_w[GMAX + 1];
  int p_run[GMAX + 1], p_term[GMAX + 1], p_deq[GMAX + 1], p_base[GMAX + 1];
  for (int j = 0; j <= G; ++j) {
    p_nw[j] = 0;
    p_n[j] = -gob;
    p_w[j] = -goa;
    p_run[j] = p_term[j] = p_deq[j] = p_base[j] = 0;
  }
  // best cell so far: score, i, j and the picked values at that cell
  int best = NEG, bi = 0, bj = 0;
  int b_nw = NEG, b_n = NEG, b_w = NEG;
  int b_run = NEG, b_term = NEG, b_deq = NEG, b_base = NEG;

  const int ni = min(rl, R);
  for (int i = 0; i < ni; ++i) {
    // band for this row (anchor_get_x_range), clipped to [0, glen-1]
    int x_min = i < ay ? 0 : (i <= ay + alen - 1 ? ax + (i - ay)
                                                  : ax + alen);
    x_min = min(max(x_min, 0), gl - 1);
    const int ay2 = ay - (awid - 1);
    int x_max = i < ay2 ? ax + awid - 2
                        : (i <= ay2 + alen - 1 ? ax + (awid - 1) + (i - ay2)
                                               : gl - 1);
    x_max = min(max(x_max, 0), gl - 1);
    // local records every row < rlen, global only the last read row
    const bool rec = local ? true : (i == rl - 1);
    const int rch = r[i];

    // diagonal (previous row, column j-1) carries, starting at the pad
    int d_nw = p_nw[0], d_n = p_n[0], d_w = p_w[0];
    int d_run = p_run[0], d_term = p_term[0], d_deq = p_deq[0],
        d_base = p_base[0];
    p_nw[0] = init_nw;
    p_n[0] = init_n;
    p_w[0] = init_w;
    p_run[0] = p_term[0] = p_deq[0] = p_base[0] = 0;

    int left_nw = init_nw;   // this row's nw at column j-1
    int c = FILL;            // running max of the W chain terms
    int rb = NEG, rj = 0;    // this row's best candidate and its column
    int r_nw = 0, r_n = 0, r_w = 0, r_run = 0, r_term = 0, r_deq = 0,
        r_base = 0;
    for (int j = 0; j < G; ++j) {
      const int u_nw = p_nw[j + 1], u_n = p_n[j + 1];   // previous row, j
      const bool inb = j >= x_min && j <= x_max;
      const int gch = g[j];
      const int s = gch == rch ? m : mm;

      // NW plane: tie preference nw > n > w, flipped under revcmpl
      int v = rv ? d_w : d_nw;
      int from = rv ? NW_FROM_W : NW_FROM_NW;
      if (d_n > v) from = NW_FROM_N;
      v = max(v, d_n);
      const int last = rv ? d_nw : d_w;
      if (last > v) from = rv ? NW_FROM_NW : NW_FROM_W;
      v = max(v, last);
      int nw_val = v + s;
      int nw_from = from;
      if (local && nw_val <= 0) {
        nw_val = 0;
        nw_from = 0;
      }

      // N plane (previous row, same column)
      const int c_open = u_nw - gob - geb;
      const int c_ext = u_n - geb;
      const bool take_ext = rv ? c_ext >= c_open : c_ext > c_open;
      int n_val = take_ext ? c_ext : c_open;
      if (local && n_val <= 0) n_val = 0;

      if (!inb) {
        nw_val = init_nw;
        nw_from = 0;
        n_val = init_n;
      }

      // W plane: running max along j; the band's left edge injects the
      // out-of-band resting value init_w as an extra candidate
      int a = left_nw - goa - gea;
      if (local) a = max(a, 0);
      if (j == x_min) a = max(a, init_w - gea);
      c = max(c, inb ? a + j * gea : FILL);
      const int w_val = inb ? c - j * gea : init_w;

      // diagonal-chain bookkeeping
      const int deq = d_deq + (gch == rch ? 1 : 0);
      const bool chain = nw_from == NW_FROM_NW;
      const int run = chain ? d_run + 1 : 0;
      const int term = chain ? d_term : nw_from;
      const int base = chain ? d_base : deq;

      if (rec && inb) {
        const int cell = max(max(n_val, nw_val), w_val);
        if (cell > rb) {
          rb = cell;
          rj = j;
          r_nw = nw_val;
          r_n = n_val;
          r_w = w_val;
          r_run = run;
          r_term = term;
          r_deq = deq;
          r_base = base;
        }
      }

      // shift the diagonal carries, then store this row's column j
      d_nw = u_nw;
      d_n = u_n;
      d_w = p_w[j + 1];
      d_run = p_run[j + 1];
      d_term = p_term[j + 1];
      d_deq = p_deq[j + 1];
      d_base = p_base[j + 1];
      p_nw[j + 1] = nw_val;
      p_n[j + 1] = n_val;
      p_w[j + 1] = w_val;
      p_run[j + 1] = run;
      p_term[j + 1] = term;
      p_deq[j + 1] = deq;
      p_base[j + 1] = base;
      left_nw = nw_val;
    }
    if (rb > best) {
      // the reference picks max(value, NEG) at the selected cell
      best = rb;
      bi = i;
      bj = rj;
      b_nw = max(r_nw, NEG);
      b_n = max(r_n, NEG);
      b_w = max(r_w, NEG);
      b_run = r_run;
      b_term = r_term;
      b_deq = r_deq;
      b_base = r_base;
    }
  }

  // _plane_from_stats
  const bool has = best > 0;
  int plane = 0;
  int fs = b_nw;
  if (b_w > fs) plane = 1;
  fs = max(fs, b_w);
  if (b_n > fs) plane = 2;
  int32_t* o = out + (size_t)b * 8;
  o[0] = max(best, 0);
  o[1] = has ? bi : 0;
  o[2] = has ? bj : 0;
  o[3] = has ? plane : 0;
  o[4] = b_run;
  o[5] = b_term;
  o[6] = b_deq;
  o[7] = b_base;
}

template <int GMAX>
void launch(const void* genome, const void* glen, const void* read,
            const void* rlen, const void* ax, const void* ay,
            const void* alen, const void* awid, const void* rev, void* out,
            int B, int G, int R, int m, int mm, int goa, int gea, int gob,
            int geb, int local, cudaStream_t stream) {
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  sw_full_stats_kernel<GMAX><<<(B + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      static_cast<const uint8_t*>(genome), i32(glen),
      static_cast<const uint8_t*>(read), i32(rlen), i32(ax), i32(ay),
      i32(alen), i32(awid), i32(rev), static_cast<int32_t*>(out), B, G, R,
      m, mm, goa, gea, gob, geb, local);
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, glen/rlen/ax/ay/alen/awid/rev [B]
// i32 -> out [B, 8] i32. goa/gea/gob/geb are the open and extend costs
// as positive penalties (open NOT including extend, as in
// sw_full_pallas). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for G > 256).
extern "C" int sw_full_stats_launch(const void* genome, const void* glen,
                                    const void* read, const void* rlen,
                                    const void* ax, const void* ay,
                                    const void* alen, const void* awid,
                                    const void* rev, void* out, int B, int G,
                                    int R, int m, int mm, int goa, int gea,
                                    int gob, int geb, int local,
                                    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 64)
    launch<64>(genome, glen, read, rlen, ax, ay, alen, awid, rev, out, B, G,
               R, m, mm, goa, gea, gob, geb, local, st);
  else if (G <= 128)
    launch<128>(genome, glen, read, rlen, ax, ay, alen, awid, rev, out, B,
                G, R, m, mm, goa, gea, gob, geb, local, st);
  else if (G <= 256)
    launch<256>(genome, glen, read, rlen, ax, ay, alen, awid, rev, out, B,
                G, R, m, mm, goa, gea, gob, geb, local, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
