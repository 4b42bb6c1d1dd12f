// The banded 3-plane affine DP of the full Smith-Waterman on Hopper
// (sm_90a), shared by the stats kernel (sw_full.cu) and the kernel with
// backpointers (sw_full_bp.cu). It is the recurrence of the Pallas TPU
// kernel shrimp_tpu/core/sw_full_pallas.py::_kernel: (NW, N, W) planes,
// global or local, the revcmpl tie-break flips, the band-left W
// injection, the out-of-band reset to each mode's init values on every
// row, and the best cell (strict > across rows, smallest j within a
// row, the value picked as max(v, NEG)).
//
// One (window, read) pair runs on a segment of L lanes of a warp (L a
// power of two, 32 = the whole warp). The work of a row covers its band
// [x_min, x_max] only: lane l owns a strip of S consecutive in-band
// columns, S = ceil(width / L) made odd so that the lanes' accesses fall
// in distinct shared-memory banks. The previous row lives in shared
// memory in place. Outside the band every plane holds a constant (the
// mode's init values; row -1 is nw = 0, n = b_gap_open, w = a_gap_open),
// and the band never moves left at either end, so a column leaves it
// only on the left and never comes back: the planes take those
// constants once, outside row 0's band and on each column as it leaves,
// and the strip loops read the previous row without a band test. A row
// runs in two passes over each strip: (1) the NW and N planes from the
// previous row (each lane reads its left neighbour's diagonal cell
// before any lane writes), gathering the strip's maximum of the W chain
// terms a_j + j * gea from the nw values it has just computed, then a
// log2(L)-step max scan across the segment for the carry; (2) the W
// plane from the carry, its from-codes and the row's best cell, reduced
// across the segment (largest value, then smallest column).
//
// What a kernel keeps of the DP is its Planes type's business: where the
// planes, the genome window, the read and the best cell's record sit in
// shared memory, and what a cell leaves beside its values (the stats
// kernel's diagonal chain, the backpointer byte). A Planes type has
//   gsh, rsh                          the staged window and read
//   Cell load(j)                      the previous row's column j
//   void reset(j, nw, n, w)           column j out of band
//   void put1(j, u, d, nw, n, nw_from, n_from, eq)
//                                     pass 1 of column j: u its previous
//                                     row, d the diagonal cell
//   int2 nn(j)                        this row's (nw, n) after pass 1
//   void put2(j, w, w_from)           pass 2 of column j
//   void pick(i, j)                   record the best cell (one lane)
//   void end_row(i, sl)               after the row (every lane)
// and the DP's unused from-codes compile away.
//
// The strip bounds pass through an empty asm statement: ptxas of CUDA
// 12.8 and 12.9 (-O1 and up, sm_90a) folds the PTX `neg.s32 t, G;
// max.s32 u, a, t; max.s32 v, u, c` that the front end makes of the
// strip loop's trip count into one VIMNMX3 whose G operand has lost its
// sign, so the count is -(j0 + G) and the loop runs off the end of
// shared memory (an illegal address on every input). The same PTX
// through ptxas -O0 is bit-equal to the plain version. PERF.md, section
// 7, quotes a twelve-line kernel that shows it on its own.
#pragma once
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace banded {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
// plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
constexpr int NW_FROM_NW = 1, NW_FROM_N = 2, NW_FROM_W = 3;
constexpr int N_FROM_N = 1, N_FROM_NW = 2;
constexpr int W_FROM_W = 1, W_FROM_NW = 2;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// a cell of the previous row: the three planes and the Planes type's own
// word (0 where it keeps none)
struct Cell {
  int nw, n, w, x;
};

// one pair's band geometry and lengths, and the costs (open and extend
// as positive penalties, open NOT including extend, as in sw_full_pallas)
struct Pair {
  int gl, rl, ax, ay, alen, awid;
};
struct Costs {
  int m, mm, goa, gea, gob, geb;
};

// max over the values of the segment's lanes below this one (FILL for
// the segment's first lane)
template <int L>
__device__ __forceinline__ int seg_exclusive_max(int v, int sl,
                                                 unsigned mask) {
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const int u = __shfl_up_sync(mask, v, d, L);
    if (sl >= d) v = max(v, u);
  }
  const int ex = __shfl_up_sync(mask, v, 1, L);
  return sl == 0 ? FILL : ex;
}

// _plane_from_stats: the plane of the best cell, 0 nw, 1 w, 2 n
__device__ __forceinline__ int best_plane(int b_nw, int b_n, int b_w) {
  int plane = 0;
  int fs = b_nw;
  if (b_w > fs) plane = 1;
  fs = max(fs, b_w);
  if (b_n > fs) plane = 2;
  return plane;
}

// The DP of one pair over rows 0 .. nrows - 1, on lane sl of a segment
// of L lanes (mask: the segment's lanes). Stages the window and the read
// (rows of G and R bytes) into the Planes' gsh and rsh, and returns the
// best value (NEG when no row recorded a cell); P.pick holds its cell.
// Global mode records only row rlen - 1, local every row below rlen.
// rv is the pair's revcmpl flag: a caller that passes a constant gets
// the flips compiled in.
template <int L, bool LOCAL, class Planes>
__device__ __forceinline__ int dp(Planes& P, int sl, unsigned mask,
                                  const uint8_t* __restrict__ genome,
                                  const uint8_t* __restrict__ read,
                                  int nrows, const Pair& p, bool rv, int G,
                                  int R, const Costs& c) {
  const int gob = c.gob, goa = c.goa, gea = c.gea, geb = c.geb;
  // out-of-band values of rows >= 0
  const int init_nw = LOCAL ? 0 : NEG;
  const int init_n = LOCAL ? -gob : NEG;   // == b_gap_open
  const int init_w = LOCAL ? -goa : NEG;   // == a_gap_open

  for (int j = sl; j < G; j += L) P.gsh[j] = genome[j];
  for (int i = sl; i < R; i += L) P.rsh[i] = read[i];
  // row -1: nw = 0, n = b_gap_open, w = a_gap_open in every column
  for (int j = sl; j < G; j += L) P.reset(j, 0, -gob, -goa);
  __syncwarp(mask);

  // pmin is the previous row's x_min (G when its band was empty); o_* the
  // pad column j = -1 of the previous row
  int pmin = 0;
  int o_nw = 0, o_n = -gob, o_w = -goa;
  int best = NEG;

  for (int i = 0; i < nrows; ++i) {
    // band for this row (anchor_get_x_range), clipped to [0, glen-1]
    int x_min = i < p.ay ? 0 : (i <= p.ay + p.alen - 1 ? p.ax + (i - p.ay)
                                                      : p.ax + p.alen);
    x_min = min(max(x_min, 0), p.gl - 1);
    const int ay2 = p.ay - (p.awid - 1);
    int x_max = i < ay2 ? p.ax + p.awid - 2
                        : (i <= ay2 + p.alen - 1
                               ? p.ax + (p.awid - 1) + (i - ay2)
                               : p.gl - 1);
    x_max = min(min(max(x_max, 0), p.gl - 1), G - 1);
    const bool rec = LOCAL ? i < p.rl : i == p.rl - 1;
    const int rch = P.rsh[i];
    // columns in band (none when glen < 1 clips the band below 0)
    const int width = x_min >= 0 ? x_max - x_min + 1 : 0;
    const int S = width > 0 ? ((width + L - 1) / L) | 1 : 0;
    int j0 = x_min + sl * S;
    int j1 = min(j0 + S, x_max + 1);   // the strip [j0, j1)
    // keep the strip bounds opaque to the optimizer (the ptxas fold, at
    // the head of this file); j1 alone suffices, j0 stays with it
    asm volatile("" : "+r"(j0), "+r"(j1));

    // ---- pass 1: NW and N planes over the strip. The diagonal
    // (previous row, column j0 - 1) is read before any lane overwrites
    // it; the previous row outside its band is a constant.
    Cell d = {o_nw, o_n, o_w, 0};
    if (j0 < j1 && j0 > 0) d = P.load(j0 - 1);
    __syncwarp(mask);
    // the columns that leave the band take the init values; row 0 sets
    // its out-of-band values after pass 2
    const int left = width > 0 ? x_min : G;
    for (int j = (i == 0 ? left : pmin) + sl; j < left; j += L)
      P.reset(j, init_nw, init_n, init_w);
    int agg = FILL;   // max of the W chain terms of columns j0+1 .. j1-1
    for (int j = j0; j < j1; ++j) {
      const Cell u = P.load(j);
      const int eq = P.gsh[j] == rch;
      // NW plane: tie preference nw > n > w, flipped under revcmpl
      int v = rv ? d.w : d.nw;
      int nw_from = rv ? NW_FROM_W : NW_FROM_NW;
      if (d.n > v) nw_from = NW_FROM_N;
      v = max(v, d.n);
      const int last = rv ? d.nw : d.w;
      if (last > v) nw_from = rv ? NW_FROM_NW : NW_FROM_W;
      v = max(v, last);
      int nw_val = v + (eq ? c.m : c.mm);
      if (LOCAL && nw_val <= 0) {
        nw_val = 0;
        nw_from = 0;
      }
      // N plane (previous row, same column); revcmpl takes ext on ties
      // (an add, not a select on rv: 3-7 % of the stats kernel's time)
      const int c_open = u.nw - gob - geb;
      const int c_ext = u.n - geb;
      const bool take_ext = c_ext + rv > c_open;
      int n_val = take_ext ? c_ext : c_open;
      int n_from = take_ext ? N_FROM_N : N_FROM_NW;
      if (LOCAL && n_val <= 0) {
        n_val = 0;
        n_from = 0;
      }
      P.put1(j, u, d, nw_val, n_val, nw_from, n_from, eq);
      // the W chain term of column j + 1 (never the band's left edge)
      if (j + 1 < j1) {
        int a = nw_val - goa - gea;
        if (LOCAL) a = max(a, 0);
        agg = max(agg, a + (j + 1) * gea);
      }
      d = u;
    }
    __syncwarp(mask);

    // the term of column j0: its left nw is the neighbour strip's last,
    // or init_nw at the band's left edge, which also injects init_w
    int left_nw = init_nw;
    int inject = INT_MIN;   // init_w - gea at the band's left edge
    if (j0 < j1) {
      if (j0 > x_min)
        left_nw = P.nn(j0 - 1).x;
      else
        inject = init_w - gea;
      int a = left_nw - goa - gea;
      if (LOCAL) a = max(a, 0);
      agg = max(agg, max(a, inject) + j0 * gea);
    }
    int cw = seg_exclusive_max<L>(agg, sl, mask);

    // ---- pass 2: the W plane, its from-codes and the row's best cell
    int wprev = j0 > x_min ? cw - (j0 - 1) * gea : init_w;
    int rb = NEG, rj = G;
    for (int j = j0; j < j1; ++j) {
      const int c_open_w = left_nw - goa - gea;
      int a = c_open_w;
      if (LOCAL) a = max(a, 0);
      cw = max(cw, max(a, inject) + j * gea);
      inject = INT_MIN;
      const int w_val = cw - j * gea;
      const int c_ext_w = wprev - gea;
      const bool take = c_ext_w + rv > c_open_w;
      int w_from = take ? W_FROM_W : W_FROM_NW;
      if (LOCAL && w_val <= 0) w_from = 0;
      const int2 t = P.nn(j);
      left_nw = t.x;
      if (rec) {
        const int cell = max(max(t.y, t.x), w_val);
        if (cell > rb) {
          rb = cell;
          rj = j;
        }
      }
      P.put2(j, w_val, w_from);
      wprev = w_val;
    }
    if (i == 0) {
      // row 0's out-of-band values are the mode's init values (outside
      // its band: no lane touches those columns in this row)
      for (int j = sl; j < G; j += L) {
        if (width > 0 && j >= x_min && j <= x_max) continue;
        P.reset(j, init_nw, init_n, init_w);
      }
    }
    if (rec) {
      // the row's best: largest value, then smallest column
#pragma unroll
      for (int dd = L / 2; dd > 0; dd >>= 1) {
        const int v2 = __shfl_xor_sync(mask, rb, dd, L);
        const int j2 = __shfl_xor_sync(mask, rj, dd, L);
        if (v2 > rb || (v2 == rb && j2 < rj)) {
          rb = v2;
          rj = j2;
        }
      }
    }
    __syncwarp(mask);
    if (rec && rb > best) {
      best = rb;
      if (sl == 0) P.pick(i, rj);
    }
    P.end_row(i, sl);
    pmin = left;
    o_nw = init_nw;
    o_n = init_n;
    o_w = init_w;
  }
  return best;
}

// The current device's opt-in limit of a block's dynamic shared memory:
// a kernel whose pair does not fit it keeps its rows in device memory.
inline cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// Threads per block for a launch of B pairs on `lanes` lanes each, at
// most max_threads: halved (down to one warp) while some SM would get
// no block or the pairs' shared memory does not fit a block. Sets the
// dynamic shared memory limit of each kernel in ks when above 48 KB.
template <class K, int N>
cudaError_t prepare(const K (&ks)[N], int B, int lanes, int max_threads,
                    int pair_bytes, int* threads, int* smem) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  int t = max_threads;
  while (t > 32 && ((long long)B * lanes / t < sms
                    || (long long)(t / lanes) * pair_bytes > optin))
    t >>= 1;
  *threads = t;
  *smem = (t / lanes) * pair_bytes;
  if (*smem <= 48 * 1024) return cudaSuccess;
  for (int k = 0; k < N && e == cudaSuccess; ++k)
    e = cudaFuncSetAttribute(ks[k],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  return e;
}

// The launch configuration of kernel k at `threads` threads per block
// and `smem` bytes: out[0..5] = pairs per block, threads per pair,
// dynamic shared memory bytes per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread
// and local (spill) bytes per thread. Returns a cudaError_t.
template <class K>
int config(K k, int lanes, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                    smem);
  out[0] = threads / lanes;
  out[1] = lanes;
  out[2] = smem;
  out[3] = blocks;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace banded
