// Colour-space full Smith-Waterman DP (filter 3), hand-written for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel shrimp_tpu/core/sw_cs_full_pallas.py::
// _kernel, reached through sw_full_cs_dp_pallas. The 4-layer banded DP of
// sw-full-cs.c: the colour read is translated into four letter reads (one
// per possible initial letter), each layer runs the (NW, N, W) affine DP
// against the letter window, and moving between layers from one row to
// the next costs that row's crossover penalty. Outputs are bit-equal to
// sw_full_cs_dp_pallas: best, bi, bj, bk, bfrm per pair and the packed
// backpointers nw | n << 5 | w << 10 of every cell, including the
// candidate order and its ties (own layer first, then the others in
// ascending order, plane order reversed under revcmpl, strict > scans),
// the per-row local inits, the taboo near the read end, the W chain's
// FILL floor and the best-cell picks.
//
// What bounds it on an H100: integer ALU. A cell of one layer weighs 12
// NW and 8 N candidates plus the W chain, about 60 int32 operations, and
// a launch computes 4*B*R*G of them. Device memory carries the
// backpointers out, 2 bytes per layer-cell (B = 2048, G = 64, R = 36:
// 37.7 MB), which the card writes in microseconds.
//
// What the simple design does about it: one thread per (window, read)
// pair, as the TPU kernel gave one lane to a pair. The thread walks rows
// i and columns j in order, so the W chain (a log-doubling cummax on the
// TPU) is a scalar running max per layer and the row's best cell a
// scalar compare. The previous row's nw, n and w of the four layers live
// in per-thread arrays of G+1 ints sized by the G bucket (a template
// parameter), updated in place with the diagonal values held in
// registers. Backpointers are int16 in a pair-fastest layout [R, 4, G, B],
// so the 32 threads of a warp store 64 contiguous bytes. Blocks are one
// warp, so that the main path's 2048-pair launches spread over 64 SMs.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 25);
constexpr int FILL = -(1 << 28);
constexpr int BLOCK = 32;
constexpr int BASE_N = 15;
// direction-pair codes of sw-full-cs.c; a backpointer is code << 2 | layer
constexpr int NN = 1, NNW = 2, WNW = 3, WW = 4, NWN = 5, NWNW = 6, NWW = 7;

// The strict-> candidate scan: the first candidate is always taken
// (every candidate exceeds INT_MIN), later ones only when greater.
struct Best {
  int val = INT_MIN;
  int bk = 0;
  __device__ void take(int c, int code, int layer) {
    if (c > val) {
      val = c;
      bk = code << 2 | layer;
    }
  }
};

template <int GMAX>
__global__ void __launch_bounds__(BLOCK)
sw_cs_full_kernel(const uint8_t* __restrict__ genome,
                  const uint8_t* __restrict__ qr,
                  const int32_t* __restrict__ xover,
                  const int32_t* __restrict__ gx_,
                  const int32_t* __restrict__ glen_,
                  const int32_t* __restrict__ rlen_,
                  const int32_t* __restrict__ ax_,
                  const int32_t* __restrict__ ay_,
                  const int32_t* __restrict__ alen_,
                  const int32_t* __restrict__ awid_,
                  const int32_t* __restrict__ rev_,
                  int16_t* __restrict__ bp, int32_t* __restrict__ stats,
                  int B, int G, int R, int m, int mm, int goa, int gea,
                  int gob, int geb, int local, int taboo) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* q = qr + (size_t)b * 4 * R;
  const int32_t* xr = xover + (size_t)b * R;
  const int gl = glen_[b], rl = rlen_[b];
  const int ax = ax_[b], ay = ay_[b], alen = alen_[b], awid = awid_[b];
  const bool rv = rev_[b] != 0;
  const int gx = gx_[b];

  // previous row per layer, index j + 1 for column j (0 is the pad
  // column j = -1); row -1 starts layer 0 at 0 and layers 1..3 at the
  // global crossover, with the N and W planes offset by the gap opens
  int p_nw[4][GMAX + 1], p_n[4][GMAX + 1], p_w[4][GMAX + 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int off = k == 0 ? 0 : gx;
    for (int j = 0; j <= G; ++j) {
      p_nw[k][j] = off;
      p_n[k][j] = off - gob;
      p_w[k][j] = off - goa;
    }
  }
  int best = 0, bi = 0, bj = 0, bk = 0, bfrm = 0;

  for (int i = 0; i < R; ++i) {
    // band for this row (anchor_get_x_range), clipped to [0, glen-1]
    int x_min = i < ay ? 0 : (i <= ay + alen - 1 ? ax + (i - ay)
                                                  : ax + alen);
    x_min = min(max(x_min, 0), gl - 1);
    const int ay2 = ay - (awid - 1);
    int x_max = i < ay2 ? ax + awid - 2
                        : (i <= ay2 + alen - 1 ? ax + (awid - 1) + (i - ay2)
                                               : gl - 1);
    x_max = min(max(x_max, 0), gl - 1);
    const int xc = xr[i];
    // taboo: no N-plane entry (or exit to NW) near the read end
    const bool no_taboo = taboo == 0 || i < rl - taboo;
    const bool rec = local ? i < rl : i == rl - 1;

    int init_nw[4], init_n[4], init_w[4], qk[4];
    int d_nw[4], d_n[4], d_w[4];   // previous row, column j - 1
    int left_nw[4], w_left[4], c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      init_nw[k] = local ? (k == 0 ? 0 : xc) : NEG;
      init_n[k] = local ? init_nw[k] - gob : NEG;
      init_w[k] = local ? init_nw[k] - goa : NEG;
      qk[k] = q[k * R + i];
      d_nw[k] = p_nw[k][0];
      d_n[k] = p_n[k][0];
      d_w[k] = p_w[k][0];
      p_nw[k][0] = init_nw[k];
      p_n[k][0] = init_n[k];
      p_w[k][0] = init_w[k];
      left_nw[k] = init_nw[k];   // this row's nw at column j - 1
      w_left[k] = init_w[k];     // this row's W value before the clamp
      c[k] = FILL;               // running max of the W chain
    }
    int rb = NEG, rj = 0, rk = 0, rfrm = 0;   // this row's best cell

    for (int j = 0; j < G; ++j) {
      const bool inb = j >= x_min && j <= x_max;
      const int gch = g[j];
      int u_nw[4], u_n[4], u_w[4];   // previous row, column j
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u_nw[k] = p_nw[k][j + 1];
        u_n[k] = p_n[k][j + 1];
        u_w[k] = p_w[k][j + 1];
      }
      int16_t* bpj = bp + ((size_t)i * 4 * G + j) * B + b;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // NW: 12 candidates, groups in layer order [k, others ascending],
        // groups after the first pay the crossover
        Best nw;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int l = gi == 0 ? k : (gi <= k ? gi - 1 : gi);
          const int x = gi == 0 ? 0 : xc;
          const int c_n = no_taboo ? d_n[l] + x : 2 * NEG;
          if (rv) {
            nw.take(d_w[l] + x, NWW, l);
            nw.take(c_n, NWN, l);
            nw.take(d_nw[l] + x, NWNW, l);
          } else {
            nw.take(d_nw[l] + x, NWNW, l);
            nw.take(c_n, NWN, l);
            nw.take(d_w[l] + x, NWW, l);
          }
        }
        const int s = (gch == BASE_N || qk[k] == BASE_N)
                          ? 0 : (gch == qk[k] ? m : mm);
        int nw_val = nw.val + s, nw_bk = nw.bk;
        if (local && nw_val <= init_nw[k]) {
          nw_val = init_nw[k];
          nw_bk = 0;
        }
        if (!inb) {
          nw_val = init_nw[k];
          nw_bk = 0;
        }

        // N: 8 candidates (open, extend) per layer group
        Best n;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int l = gi == 0 ? k : (gi <= k ? gi - 1 : gi);
          const int x = gi == 0 ? 0 : xc;
          const int c_open = no_taboo ? u_nw[l] - gob - geb + x : 2 * NEG;
          const int c_ext = u_n[l] - geb + x;
          if (rv) {
            n.take(c_ext, NN, l);
            n.take(c_open, NNW, l);
          } else {
            n.take(c_open, NNW, l);
            n.take(c_ext, NN, l);
          }
        }
        int n_val = n.val, n_bk = n.bk;
        if (local && n_val <= init_nw[k]) {
          n_val = init_nw[k];
          n_bk = 0;
        }
        if (!inb) {
          n_val = init_n[k];
          n_bk = 0;
        }

        // W: this layer's chain along j; the band's left edge injects
        // init_w as an extra candidate; out-of-band cells add FILL
        const int c_open_w = no_taboo ? left_nw[k] - goa - gea : 2 * NEG;
        int a = c_open_w;
        if (local) a = max(a, init_nw[k]);
        if (j == x_min) a = max(a, init_w[k] - gea);
        c[k] = max(c[k], inb ? a + j * gea : FILL);
        const int w_raw = inb ? c[k] - j * gea : init_w[k];
        const int c_ext_w = w_left[k] - gea;
        const bool take_ext = rv ? !(c_open_w > c_ext_w) : c_ext_w > c_open_w;
        int w_val = w_raw;
        int w_bk = (take_ext ? WW : WNW) << 2 | k;
        if (local && w_raw <= init_nw[k]) {
          w_val = init_nw[k];
          w_bk = 0;
        }
        if (!inb) w_bk = 0;
        w_left[k] = w_raw;
        left_nw[k] = nw_val;

        bpj[(size_t)k * G * B] = (int16_t)(nw_bk | n_bk << 5 | w_bk << 10);

        // best cell: first (j, then k) holding the row's maximum
        if (rec && inb) {
          const int cm = max(max(nw_val, n_val), w_val);
          if (cm > rb) {
            rb = cm;
            rj = j;
            rk = k;
            // the reference picks max(value, NEG) at the selected cell,
            // then prefers nw, w if strictly greater, then n
            const int nw_c = max(nw_val, NEG), n_c = max(n_val, NEG),
                      w_c = max(w_val, NEG);
            int frm = nw_bk, fs = nw_c;
            if (w_c > fs) frm = w_bk;
            fs = max(fs, w_c);
            if (n_c > fs) frm = n_bk;
            rfrm = frm;
          }
        }

        // store this row's column j (every layer read column j above)
        p_nw[k][j + 1] = nw_val;
        p_n[k][j + 1] = n_val;
        p_w[k][j + 1] = w_val;
      }
      // shift the diagonal carries once all four layers are done
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d_nw[k] = u_nw[k];
        d_n[k] = u_n[k];
        d_w[k] = u_w[k];
      }
    }
    if (rb > best) {
      best = rb;
      bi = i;
      bj = rj;
      bk = rk;
      bfrm = rfrm;
    }
  }
  stats[b] = best;
  stats[B + b] = bi;
  stats[2 * B + b] = bj;
  stats[3 * B + b] = bk;
  stats[4 * B + b] = bfrm;
}

template <int GMAX>
void launch(const void* const* in, void* bp, void* stats, int B, int G,
            int R, int m, int mm, int goa, int gea, int gob, int geb,
            int local, int taboo, cudaStream_t stream) {
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  sw_cs_full_kernel<GMAX><<<(B + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      u8(in[0]), u8(in[1]), i32(in[2]), i32(in[3]), i32(in[4]), i32(in[5]),
      i32(in[6]), i32(in[7]), i32(in[8]), i32(in[9]), i32(in[10]),
      static_cast<int16_t*>(bp), static_cast<int32_t*>(stats), B, G, R, m,
      mm, goa, gea, gob, geb, local, taboo);
}

}  // namespace

// genome [B, G] u8 (letters), qr [B, 4, R] u8 (letter layers), xover
// [B, R] i32, gx/glen/rlen/ax/ay/alen/awid/rev [B] i32 -> bp [R, 4, G, B]
// i16, stats [5, B] i32 (best, bi, bj, bk, bfrm). goa/gea/gob/geb are the
// open and extend costs as positive penalties (open NOT including
// extend). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for G > 256).
extern "C" int sw_cs_full_launch(const void* genome, const void* qr,
                                 const void* xover, const void* gx,
                                 const void* glen, const void* rlen,
                                 const void* ax, const void* ay,
                                 const void* alen, const void* awid,
                                 const void* rev, void* bp, void* stats,
                                 int B, int G, int R, int m, int mm, int goa,
                                 int gea, int gob, int geb, int local,
                                 int taboo, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[] = {genome, qr, xover, gx, glen, rlen,
                      ax, ay, alen, awid, rev};
  if (G <= 64)
    launch<64>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb, local,
               taboo, st);
  else if (G <= 128)
    launch<128>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb, local,
                taboo, st);
  else if (G <= 256)
    launch<256>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb, local,
                taboo, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
