// Full Smith-Waterman with backpointers (filter 3, traceback flow),
// hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel shrimp_tpu/core/sw_full_pallas.py::
// _kernel with emit_bp=True, reached through sw_full_batch_pallas
// (including its _plane_from_stats epilogue). The banded 3-plane
// (NW, N, W) affine DP, global or local, with the revcmpl tie-break flip,
// the band-left W injection and the out-of-band reset to each mode's
// init values on every row, over all R rows as the Pallas grid (nb, R)
// runs them. Outputs are bit-equal to sw_full_batch_pallas: st [4, B]
// int32 = score, max_i, max_j, plane, and the backpointers
// nw | n << 2 | w << 4 of every cell as uint8 [B, R, G] (out-of-band
// cells 0), for every G up to 4095 (the packed flow's 14-bit glen).
//
// What bounds it on an H100: integer ALU over the in-band cells, about
// thirty int32 operations each, and the fixed work of every row (the
// band, three warp syncs, the W chain's scan, the row store); device
// memory for the backpointer stream (one byte a cell, every cell of
// [B, R, G] written once). The band holds a fraction of the R x G cells
// (about a third on chip_smoke's test pairs, about 6 % on the 250 bp
// flow's windows), and the flow's launches carry pad rows whose band is
// one column wide.
//
// What the design does about it: the work of a row covers its band
// [x_min, x_max] only. One warp per (window, read) pair and, when the
// launch has enough pairs to give every SM a block, PAIRS pairs per
// block, at most 64 registers a thread (__launch_bounds__), so 32 warps
// stay resident per SM. Lane l owns a strip of S consecutive in-band
// columns, S = ceil(width / 32) made odd so that the lanes' accesses
// fall in distinct shared-memory banks. Cells outside the band hold
// constants (the mode's init values, and 0 / b_gap_open / a_gap_open for
// row -1). The band never moves left at either end, so a column leaves
// it only on the left and never comes back: the planes keep those
// constants outside the band (for every column after row 0, then for
// each column as it leaves), and the strip loops read the previous row
// without a band test. The previous row's
// planes live in shared memory in place, (nw, n) as int2 and w apart,
// beside the genome window, the read, the backpointer row and the best
// cell's record (kept out of registers: it changes on few rows). A row
// runs in two passes over each strip: (1) the NW and N planes from the
// previous row (each lane reads its left neighbour's diagonal cell
// before any lane writes), gathering the strip's maximum of the W chain
// terms a_j + j*gea from the nw values it has just computed, then a
// 5-step __shfl_up_sync max scan for the carry; (2) the W plane from
// the carry, its from-codes and the row's best cell, reduced across
// lanes with __shfl_xor_sync (largest value, then smallest column). The
// mode and the pair's revcmpl flag are template parameters, so the
// tie-break flips and local clamps cost nothing in the strip loops. The
// backpointer row is kept zero outside the band (the columns that leave
// the band are cleared) and leaves shared memory whole, in 16-byte
// coalesced stores, so every byte of the output is written.
//
// A ptxas fault this source works around: the strip bounds pass through
// an empty asm statement, so that the front end cannot rewrite the strip
// loop's trip count as min/max terms of the band. ptxas of CUDA 12.8 and
// 12.9 (-O1 and up, sm_90a) folds the PTX `neg.s32 t, G; max.s32 u, a, t;
// max.s32 v, u, c` into one VIMNMX3 whose G operand has lost its sign, so
// the count is -(j0 + G) and the loop runs off the end of shared memory
// (an illegal address on every input). The same PTX through ptxas -O0 is
// bit-equal to the plain version. A twelve-line kernel that computes the
// same strip bounds and counts its loop's iterations shows it on its own;
// PERF.md, section 7, quotes it.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
constexpr int PAIRS = 4;   // warps, one pair each, per block (large B)
constexpr unsigned FULL_MASK = 0xffffffffu;
// plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
constexpr int NW_FROM_NW = 1, NW_FROM_N = 2, NW_FROM_W = 3;
constexpr int N_FROM_N = 1, N_FROM_NW = 2;
constexpr int W_FROM_W = 1, W_FROM_NW = 2;

// max over the values of the lanes below this one (FILL for lane 0)
__device__ __forceinline__ int warp_exclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v = max(v, u);
  }
  const int ex = __shfl_up_sync(FULL_MASK, v, 1);
  return lane == 0 ? FILL : ex;
}

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// bytes of shared memory of one pair of G columns and R rows: the three
// planes, the genome window, the backpointer row, the read and the best
// cell's record
__host__ __device__ inline int pair_bytes(int G, int R) {
  return pad16(3 * G * 4) + 2 * pad16(G) + pad16(R) + 32;
}

// One (window, read) pair on one warp, with the mode and the revcmpl
// flag fixed at compile time (the tie-break flips and local clamps cost
// no instructions in the strip loops).
template <bool LOCAL, bool RV>
__device__ __forceinline__ void align_pair(
    int b, int lane, uint8_t* base, const uint8_t* __restrict__ genome,
    const uint8_t* __restrict__ read, int gl, int rl, int ax, int ay,
    int alen, int awid, int32_t* __restrict__ st_out,
    uint8_t* __restrict__ bp, int B, int G, int R, int m, int mm, int goa,
    int gea, int gob, int geb) {
  int2* p_nn = reinterpret_cast<int2*>(base);   // (nw, n) of column j
  int* p_w = reinterpret_cast<int*>(p_nn + G);
  uint8_t* gsh = base + pad16(3 * G * 4);
  uint8_t* bprow = gsh + pad16(G);
  uint8_t* rsh = bprow + pad16(G);
  int* pick = reinterpret_cast<int*>(rsh + pad16(R));   // bi, bj, nw, n, w
  uint8_t* bpo = bp + (size_t)b * R * G;
  // out-of-band values of rows >= 0
  const int init_nw = LOCAL ? 0 : NEG;
  const int init_n = LOCAL ? -gob : NEG;   // == b_gap_open
  const int init_w = LOCAL ? -goa : NEG;   // == a_gap_open

  for (int j = lane; j < G; j += 32) gsh[j] = genome[(size_t)b * G + j];
  for (int i = lane; i < R; i += 32) rsh[i] = read[(size_t)b * R + i];
  for (int j = lane; j < pad16(G); j += 32) bprow[j] = 0;
  // row -1: nw = 0, n = b_gap_open, w = a_gap_open in every column
  for (int j = lane; j < G; j += 32) {
    p_nn[j] = make_int2(0, -gob);
    p_w[j] = -goa;
  }
  __syncwarp();

  // The band never moves left at either end, so a column leaves it only
  // on the left and never comes back. The planes hold the previous row in
  // its band and that row's out-of-band values elsewhere: row -1's in
  // every column at first; the mode's init values outside row 0's band
  // after it; columns that leave the band are reset to them. pmin is the
  // previous row's x_min (G when its band was empty); o_* the pad
  // column j = -1 of the previous row.
  int pmin = 0;
  int o_nw = 0, o_n = -gob, o_w = -goa;
  const bool vec16 = (G & 15) == 0;
  int best = NEG;
  if (lane == 0) {
    pick[0] = pick[1] = 0;
    pick[2] = pick[3] = pick[4] = NEG;
  }

  for (int i = 0; i < R; ++i) {
    // band for this row (anchor_get_x_range), clipped to [0, glen-1]
    int x_min = i < ay ? 0 : (i <= ay + alen - 1 ? ax + (i - ay)
                                                  : ax + alen);
    x_min = min(max(x_min, 0), gl - 1);
    const int ay2 = ay - (awid - 1);
    int x_max = i < ay2 ? ax + awid - 2
                        : (i <= ay2 + alen - 1 ? ax + (awid - 1) + (i - ay2)
                                               : gl - 1);
    x_max = min(min(max(x_max, 0), gl - 1), G - 1);
    // local records every row < rlen, global only the last read row
    const bool rec = LOCAL ? (i < rl) : (i == rl - 1);
    const int rch = rsh[i];
    // columns in band (none when glen < 1 clips the band below 0)
    const int width = x_min >= 0 ? x_max - x_min + 1 : 0;
    const int S = width > 0 ? ((width + 31) >> 5) | 1 : 0;
    int j0 = x_min + lane * S;
    int j1 = min(j0 + S, x_max + 1);   // the strip [j0, j1)
    // Keep the strip bounds opaque to the optimizer (a ptxas fault, see
    // the head of this file): without this, the front end writes pass 1's
    // trip count j1 - j0 as min/max terms of the band, among them
    // max(max(-gl, -G), ~x_max), and ptxas (CUDA 12.8 and 12.9, -O1 and
    // up) folds that into one three-input max that drops the sign of G.
    // The trip count comes out as -(j0 + G) and the loop runs off the end
    // of shared memory. j1 alone suffices; j0 stays with it.
    asm volatile("" : "+r"(j0), "+r"(j1));

    // ---- pass 1: NW and N planes over the strip. The diagonal
    // (previous row, column j0 - 1) is read before any lane overwrites
    // it; the previous row outside its band is a constant.
    int d_nw = o_nw, d_n = o_n, d_w = o_w;
    if (j0 < j1 && j0 > 0) {
      const int2 t = p_nn[j0 - 1];
      d_nw = t.x;
      d_n = t.y;
      d_w = p_w[j0 - 1];
    }
    __syncwarp();
    // the columns that leave the band: init values, and no backpointers
    // (bprow is zero outside the band); row 0 sets its out-of-band
    // values below
    const int left = width > 0 ? x_min : G;
    for (int j = (i == 0 ? left : pmin) + lane; j < left; j += 32) {
      p_nn[j] = make_int2(init_nw, init_n);
      p_w[j] = init_w;
      bprow[j] = 0;
    }
    int agg = FILL;   // max of the W chain terms of columns j0+1 .. j1-1
    for (int j = j0; j < j1; ++j) {
      const int2 t = p_nn[j];
      const int u_nw = t.x, u_n = t.y;
      const int u_w = p_w[j];
      const int s = gsh[j] == rch ? m : mm;
      // NW plane: tie preference nw > n > w, flipped under revcmpl
      int v = RV ? d_w : d_nw;
      int nw_from = RV ? NW_FROM_W : NW_FROM_NW;
      if (d_n > v) nw_from = NW_FROM_N;
      v = max(v, d_n);
      const int last = RV ? d_nw : d_w;
      if (last > v) nw_from = RV ? NW_FROM_NW : NW_FROM_W;
      v = max(v, last);
      int nw_val = v + s;
      if (LOCAL && nw_val <= 0) {
        nw_val = 0;
        nw_from = 0;
      }
      // N plane (previous row, same column)
      const int c_open = u_nw - gob - geb;
      const int c_ext = u_n - geb;
      const bool take_ext = RV ? c_ext >= c_open : c_ext > c_open;
      int n_val = take_ext ? c_ext : c_open;
      int n_from = take_ext ? N_FROM_N : N_FROM_NW;
      if (LOCAL && n_val <= 0) {
        n_val = 0;
        n_from = 0;
      }
      p_nn[j] = make_int2(nw_val, n_val);
      bprow[j] = static_cast<uint8_t>(nw_from | (n_from << 2));
      // the W chain term of column j + 1 (never the band's left edge)
      if (j + 1 < j1) {
        int a = nw_val - goa - gea;
        if (LOCAL) a = max(a, 0);
        agg = max(agg, a + (j + 1) * gea);
      }
      d_nw = u_nw;
      d_n = u_n;
      d_w = u_w;
    }
    __syncwarp();

    // the term of column j0: its left nw is the neighbour strip's last,
    // or init_nw at the band's left edge, which also injects init_w
    int left_nw = init_nw;
    int inject = INT_MIN;   // init_w - gea at the band's left edge
    if (j0 < j1) {
      if (j0 > x_min)
        left_nw = p_nn[j0 - 1].x;
      else
        inject = init_w - gea;
      int a = left_nw - goa - gea;
      if (LOCAL) a = max(a, 0);
      agg = max(agg, max(a, inject) + j0 * gea);
    }
    int c = warp_exclusive_max(agg, lane);

    // ---- pass 2: the W plane, its from-codes and the row's best cell
    int wprev = j0 > x_min ? c - (j0 - 1) * gea : init_w;
    int rb = NEG, rj = G;
    for (int j = j0; j < j1; ++j) {
      const int c_open_w = left_nw - goa - gea;
      int a = c_open_w;
      if (LOCAL) a = max(a, 0);
      c = max(c, max(a, inject) + j * gea);
      inject = INT_MIN;
      const int w_val = c - j * gea;
      const int c_ext_w = wprev - gea;
      const bool take = RV ? c_ext_w >= c_open_w : c_ext_w > c_open_w;
      int w_from = take ? W_FROM_W : W_FROM_NW;
      if (LOCAL && w_val <= 0) w_from = 0;
      const int2 t = p_nn[j];
      left_nw = t.x;
      if (rec) {
        const int cell = max(max(t.y, left_nw), w_val);
        if (cell > rb) {
          rb = cell;
          rj = j;
        }
      }
      p_w[j] = w_val;
      bprow[j] |= static_cast<uint8_t>(w_from << 4);
      wprev = w_val;
    }
    if (i == 0) {
      // row 0's out-of-band values are the mode's init values (outside
      // its band: no lane touches those columns in this row)
      for (int j = lane; j < G; j += 32) {
        if (width > 0 && j >= x_min && j <= x_max) continue;
        p_nn[j] = make_int2(init_nw, init_n);
        p_w[j] = init_w;
      }
    }
    if (rec) {
      // the row's best: largest value, then smallest column
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const int v2 = __shfl_xor_sync(FULL_MASK, rb, d);
        const int j2 = __shfl_xor_sync(FULL_MASK, rj, d);
        if (v2 > rb || (v2 == rb && j2 < rj)) {
          rb = v2;
          rj = j2;
        }
      }
    }
    __syncwarp();
    if (rec && rb > best) {
      // the reference picks max(value, NEG) at the selected cell
      best = rb;
      if (lane == 0) {
        pick[0] = i;
        pick[1] = rj;
        pick[2] = max(p_nn[rj].x, NEG);
        pick[3] = max(p_nn[rj].y, NEG);
        pick[4] = max(p_w[rj], NEG);
      }
    }
    // the whole backpointer row (zero outside the band)
    uint8_t* dst = bpo + (size_t)i * G;
    if (vec16) {
      for (int q = lane; q < G / 16; q += 32)
        reinterpret_cast<int4*>(dst)[q] =
            reinterpret_cast<const int4*>(bprow)[q];
    } else {
      for (int j = lane; j < G; j += 32) dst[j] = bprow[j];
    }
    pmin = left;
    o_nw = init_nw;
    o_n = init_n;
    o_w = init_w;
  }

  if (lane == 0) {
    // _plane_from_stats
    const int bi = pick[0], bj = pick[1], b_nw = pick[2], b_n = pick[3],
              b_w = pick[4];
    const bool has = best > 0;
    int plane = 0;
    int fs = b_nw;
    if (b_w > fs) plane = 1;
    fs = max(fs, b_w);
    if (b_n > fs) plane = 2;
    st_out[b] = max(best, 0);
    st_out[B + b] = has ? bi : 0;
    st_out[2 * B + b] = has ? bj : 0;
    st_out[3 * B + b] = has ? plane : 0;
  }
}

template <bool LOCAL>
__global__ void __launch_bounds__(32 * PAIRS, 8)
sw_full_bp_kernel(const uint8_t* __restrict__ genome,
                  const int32_t* __restrict__ glen,
                  const uint8_t* __restrict__ read,
                  const int32_t* __restrict__ rlen,
                  const int32_t* __restrict__ ax,
                  const int32_t* __restrict__ ay,
                  const int32_t* __restrict__ alen,
                  const int32_t* __restrict__ awid,
                  const int32_t* __restrict__ rev,
                  int32_t* __restrict__ st_out, uint8_t* __restrict__ bp,
                  int B, int G, int R, int m, int mm, int goa, int gea,
                  int gob, int geb) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem) + warp * pair_bytes(G, R);
  if (rev[b] != 0)
    align_pair<LOCAL, true>(b, lane, base, genome, read, glen[b], rlen[b],
                            ax[b], ay[b], alen[b], awid[b], st_out, bp, B, G,
                            R, m, mm, goa, gea, gob, geb);
  else
    align_pair<LOCAL, false>(b, lane, base, genome, read, glen[b], rlen[b],
                             ax[b], ay[b], alen[b], awid[b], st_out, bp, B,
                             G, R, m, mm, goa, gea, gob, geb);
}

// Pairs per block for a launch of B pairs of G columns: PAIRS when every
// SM still gets a block and PAIRS pairs' shared memory fits a block, else
// fewer. Sets both kernels' dynamic shared memory limit when above 48 KB.
cudaError_t prepare(int B, int G, int R, int* pairs, int* smem) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  int p = B / PAIRS >= sms ? PAIRS : 1;
  while (p > 1 && p * pair_bytes(G, R) > optin) --p;
  *pairs = p;
  *smem = p * pair_bytes(G, R);
  if (*smem <= 48 * 1024) return cudaSuccess;
  e = cudaFuncSetAttribute(sw_full_bp_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sw_full_bp_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, glen/rlen/ax/ay/alen/awid/rev [B]
// i32 -> st [4, B] i32 (score, max_i, max_j, plane), bp [B, R, G] u8,
// every byte written. goa/gea/gob/geb are the open and extend costs as
// positive penalties (open NOT including extend, as in sw_full_pallas).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// G outside [1, 4095]).
extern "C" int sw_full_bp_launch(const void* genome, const void* glen,
                                 const void* read, const void* rlen,
                                 const void* ax, const void* ay,
                                 const void* alen, const void* awid,
                                 const void* rev, void* st, void* bp, int B,
                                 int G, int R, int m, int mm, int goa,
                                 int gea, int gob, int geb, int local,
                                 void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (G < 1 || G > 4095) return static_cast<int>(cudaErrorInvalidValue);
  int pairs = 1, smem = 0;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = local ? sw_full_bp_kernel<true> : sw_full_bp_kernel<false>;
  kernel<<<(B + pairs - 1) / pairs, 32 * pairs, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), i32(glen),
      static_cast<const uint8_t*>(read), i32(rlen), i32(ax), i32(ay),
      i32(alen), i32(awid), i32(rev), static_cast<int32_t*>(st),
      static_cast<uint8_t*>(bp), B, G, R, m, mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration of B pairs of G columns and R rows (of the
// global-mode kernel, the main path's): out[0..5] = pairs per block, threads per
// pair, dynamic shared memory bytes per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread
// and local (spill) bytes per thread. Returns a cudaError_t.
extern "C" int sw_full_bp_config(int B, int G, int R, void* out) {
  if (G < 1 || G > 4095 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  int pairs = 1, smem = 0;
  cudaError_t e = prepare(B, G, R, &pairs, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, sw_full_bp_kernel<false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sw_full_bp_kernel<false>, 32 * pairs, smem);
  o[0] = pairs;
  o[1] = 32;
  o[2] = smem;
  o[3] = blocks;
  o[4] = fa.numRegs;
  o[5] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(e);
}
