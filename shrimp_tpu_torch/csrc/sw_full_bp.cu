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
// What bounds it on an H100: integer ALU for the DP, about thirty int32
// operations a cell over B*R*G cells; device memory only for the
// backpointer stream (one byte a cell, written once).
//
// What the design does about it: one warp per (window, read) pair, so a
// launch of a few thousand long pairs still fills the card (one thread
// per pair would leave most SMs idle and keep G-wide planes in local
// memory). Lane l owns a strip of S consecutive columns (S odd, so the
// lanes' int accesses fall in distinct shared-memory banks). The
// previous row's three planes (3 * (G+1) int32), the genome window and
// the backpointer row live in shared memory. A row runs in three passes
// over each strip: (1) the NW and N planes, which need only the previous
// row (each lane reads its left neighbour's diagonal cell before any
// lane writes); (2) the strip's maximum of the W chain terms
// a_k + k*gea, combined across lanes by a 5-step __shfl_up_sync max
// scan; (3) the W plane from the scanned carry, its from-codes and the
// row's best cell, reduced across lanes with __shfl_xor_sync (largest
// value, then smallest column). The finished backpointer row leaves
// shared memory in 16-byte coalesced stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
constexpr unsigned FULL_MASK = 0xffffffffu;
// plane from-codes (shrimp_tpu/core/sw_full_pallas.py)
constexpr int NW_FROM_NW = 1, NW_FROM_N = 2, NW_FROM_W = 3;
constexpr int N_FROM_N = 1, N_FROM_NW = 2;
constexpr int W_FROM_W = 1, W_FROM_NW = 2;

// max over the values of the lanes below this one (FILL for lane 0)
__device__ __forceinline__ int warp_exclusive_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v = max(v, u);
  }
  const int ex = __shfl_up_sync(FULL_MASK, v, 1);
  return lane == 0 ? FILL : ex;
}

// bytes of dynamic shared memory for windows of G columns
__host__ __device__ inline int plane_bytes(int G) {
  return (3 * (G + 1) * 4 + 15) & ~15;
}
__host__ __device__ inline int pad16(int G) { return (G + 15) & ~15; }

__global__ void __launch_bounds__(32)
sw_full_bp_kernel(const uint8_t* __restrict__ genome,
                  const int32_t* __restrict__ glen,
                  const uint8_t* __restrict__ read,
                  const int32_t* __restrict__ rlen,
                  const int32_t* __restrict__ ax_,
                  const int32_t* __restrict__ ay_,
                  const int32_t* __restrict__ alen_,
                  const int32_t* __restrict__ awid_,
                  const int32_t* __restrict__ rev,
                  int32_t* __restrict__ st_out, uint8_t* __restrict__ bp,
                  int B, int G, int R, int S, int m, int mm, int goa,
                  int gea, int gob, int geb, int local) {
  extern __shared__ int4 smem[];
  int* p_nw = reinterpret_cast<int*>(smem);   // index j + 1 for column j
  int* p_n = p_nw + (G + 1);
  int* p_w = p_n + (G + 1);
  uint8_t* gsh = reinterpret_cast<uint8_t*>(smem) + plane_bytes(G);
  uint8_t* bprow = gsh + pad16(G);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int gl = glen[b], rl = rlen[b];
  const int ax = ax_[b], ay = ay_[b], alen = alen_[b], awid = awid_[b];
  const bool rv = rev[b] != 0;
  const uint8_t* rd = read + (size_t)b * R;
  uint8_t* bpo = bp + (size_t)b * R * G;
  // out-of-band resting values and the pad column j = -1 of rows >= 0
  const int init_nw = local ? 0 : NEG;
  const int init_n = local ? -gob : NEG;   // == b_gap_open
  const int init_w = local ? -goa : NEG;   // == a_gap_open

  for (int j = lane; j < G; j += 32) gsh[j] = genome[(size_t)b * G + j];
  // row -1 is nw = 0, n = b_gap_open, w = a_gap_open in both modes
  for (int j = lane; j <= G; j += 32) {
    p_nw[j] = 0;
    p_n[j] = -gob;
    p_w[j] = -goa;
  }
  __syncwarp();

  const int j0 = min(lane * S, G), j1 = min(j0 + S, G);
  const bool vec16 = (G & 15) == 0;
  int best = NEG, bi = 0, bj = 0, b_nw = NEG, b_n = NEG, b_w = NEG;

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
    // local records every row < rlen, global only the last read row
    const bool rec = local ? (i < rl) : (i == rl - 1);
    const int rch = rd[i];

    // ---- pass 1: NW and N planes. The diagonal (previous row, column
    // j0 - 1) is read before any lane overwrites it.
    int d_nw = 0, d_n = 0, d_w = 0;
    if (j0 < j1) {
      d_nw = p_nw[j0];
      d_n = p_n[j0];
      d_w = p_w[j0];
    }
    __syncwarp();
    if (lane == 0) {
      p_nw[0] = init_nw;
      p_n[0] = init_n;
      p_w[0] = init_w;
    }
    for (int j = j0; j < j1; ++j) {
      const int u_nw = p_nw[j + 1], u_n = p_n[j + 1], u_w = p_w[j + 1];
      const bool inb = j >= x_min && j <= x_max;
      const int s = gsh[j] == rch ? m : mm;
      // NW plane: tie preference nw > n > w, flipped under revcmpl
      int v = rv ? d_w : d_nw;
      int nw_from = rv ? NW_FROM_W : NW_FROM_NW;
      if (d_n > v) nw_from = NW_FROM_N;
      v = max(v, d_n);
      const int last = rv ? d_nw : d_w;
      if (last > v) nw_from = rv ? NW_FROM_NW : NW_FROM_W;
      v = max(v, last);
      int nw_val = v + s;
      if (local && nw_val <= 0) {
        nw_val = 0;
        nw_from = 0;
      }
      // N plane (previous row, same column)
      const int c_open = u_nw - gob - geb;
      const int c_ext = u_n - geb;
      const bool take_ext = rv ? c_ext >= c_open : c_ext > c_open;
      int n_val = take_ext ? c_ext : c_open;
      int n_from = take_ext ? N_FROM_N : N_FROM_NW;
      if (local && n_val <= 0) {
        n_val = 0;
        n_from = 0;
      }
      if (!inb) {
        nw_val = init_nw;
        nw_from = 0;
        n_val = init_n;
        n_from = 0;
      }
      p_nw[j + 1] = nw_val;
      p_n[j + 1] = n_val;
      bprow[j] = static_cast<uint8_t>(nw_from | (n_from << 2));
      d_nw = u_nw;
      d_n = u_n;
      d_w = u_w;
    }
    __syncwarp();

    // ---- pass 2: the strip's maximum of the in-band W chain terms
    // a_k + k*gea, where a_k is this row's nw at k-1 less the open cost,
    // then the carry from the strips to the left
    const int lo = max(j0, x_min), hi = min(j1 - 1, x_max);
    int agg = FILL;
    for (int j = lo; j <= hi; ++j) {
      int a = p_nw[j] - goa - gea;
      if (local) a = max(a, 0);
      if (j == x_min) a = max(a, init_w - gea);
      agg = max(agg, a + j * gea);
    }
    int c = warp_exclusive_max(agg, lane);

    // ---- pass 3: the W plane, its from-codes and the row's best cell
    int wprev = init_w;   // this row's w at column j0 - 1
    if (j0 > 0 && j0 - 1 >= x_min && j0 - 1 <= x_max)
      wprev = c - (j0 - 1) * gea;
    int rb = NEG, rj = G;
    for (int j = j0; j < j1; ++j) {
      int w_val = init_w, w_from = 0;
      if (j >= x_min && j <= x_max) {
        const int c_open_w = p_nw[j] - goa - gea;
        int a = c_open_w;
        if (local) a = max(a, 0);
        if (j == x_min) a = max(a, init_w - gea);
        c = max(c, a + j * gea);
        w_val = c - j * gea;
        const int c_ext_w = wprev - gea;
        const bool take = rv ? c_ext_w >= c_open_w : c_ext_w > c_open_w;
        w_from = take ? W_FROM_W : W_FROM_NW;
        if (local && w_val <= 0) w_from = 0;
        if (rec) {
          const int cell = max(max(p_n[j + 1], p_nw[j + 1]), w_val);
          if (cell > rb) {
            rb = cell;
            rj = j;
          }
        }
      }
      p_w[j + 1] = w_val;
      bprow[j] |= static_cast<uint8_t>(w_from << 4);
      wprev = w_val;
    }
    if (rec) {
      // the row's best: largest value, then smallest column
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
      bi = i;
      bj = rj;
      b_nw = max(p_nw[rj + 1], NEG);
      b_n = max(p_n[rj + 1], NEG);
      b_w = max(p_w[rj + 1], NEG);
    }
    uint8_t* dst = bpo + (size_t)i * G;
    if (vec16) {
      for (int q = lane; q < G / 16; q += 32)
        reinterpret_cast<int4*>(dst)[q] =
            reinterpret_cast<const int4*>(bprow)[q];
    } else {
      for (int j = lane; j < G; j += 32) dst[j] = bprow[j];
    }
    __syncwarp();
  }

  if (lane == 0) {
    // _plane_from_stats
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

}  // namespace

// genome [B, G] u8, read [B, R] u8, glen/rlen/ax/ay/alen/awid/rev [B]
// i32 -> st [4, B] i32 (score, max_i, max_j, plane), bp [B, R, G] u8.
// goa/gea/gob/geb are the open and extend costs as positive penalties
// (open NOT including extend, as in sw_full_pallas). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for G
// outside [1, 4095]).
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
  const int S = ((G + 31) / 32) | 1;
  const int smem = plane_bytes(G) + 2 * pad16(G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_full_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  sw_full_bp_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), i32(glen),
      static_cast<const uint8_t*>(read), i32(rlen), i32(ax), i32(ay),
      i32(alen), i32(awid), i32(rev), static_cast<int32_t*>(st),
      static_cast<uint8_t*>(bp), B, G, R, S, m, mm, goa, gea, gob, geb,
      local);
  return static_cast<int>(cudaGetLastError());
}
