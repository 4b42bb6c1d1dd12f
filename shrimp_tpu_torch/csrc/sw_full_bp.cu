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
// cells 0), for any G.
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
// What the design does about it: the DP of banded_sw.cuh (band-only
// work, the previous row's planes in shared memory) on one warp per
// (window, read) pair and, when the launch has enough pairs to give
// every SM a block, PAIRS pairs per block, at most 64 registers a thread
// (__launch_bounds__), so 32 warps stay resident per SM. The planes sit
// in shared memory as (nw, n) int2 and w apart, beside the genome
// window, the read, the backpointer row and the best cell's record
// (kept out of registers: it changes on few rows). The pair's revcmpl
// flag is a constant in each of two inlined copies of the DP, so the
// tie-break flips cost nothing in the strip loops. The backpointer row
// is kept zero outside the band (the columns that leave the band are
// cleared) and leaves shared memory whole, in 16-byte coalesced stores,
// so every byte of the output is written. A pair's shared memory is
// about 14 bytes a column plus the read, which fits a block to about
// 16,000 columns (the 227 KB a block can opt into); past that the
// kernel's GLOBAL instance keeps the same layout in a device-memory
// scratch that the caller allocates.
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

using banded::Cell;
using banded::NEG;
using banded::pad16;

constexpr int PAIRS = 4;   // warps, one pair each, per block (large B)
constexpr unsigned FULL_MASK = 0xffffffffu;

// A pair's shared memory: the three planes, the genome window, the
// backpointer row, the read and the best cell's record; the pair's rows
// of the backpointers in device memory.
struct BpPlanes {
  int2* nnp;   // (nw, n) of column j
  int* wp;     // w of column j
  uint8_t* gsh;
  uint8_t* bprow;
  uint8_t* rsh;
  int* pk;     // the best cell: i, j, nw, n, w
  uint8_t* bpo;
  int G;

  __host__ __device__ static long long bytes(int G, int R) {
    return pad16(3 * G * 4) + 2LL * pad16(G) + pad16(R) + 32;
  }
  __device__ BpPlanes(uint8_t* base, uint8_t* bpo, int G, int R)
      : nnp(reinterpret_cast<int2*>(base)),
        wp(reinterpret_cast<int*>(base) + 2 * G),
        gsh(base + pad16(3 * G * 4)),
        bprow(gsh + pad16(G)),
        rsh(bprow + pad16(G)),
        pk(reinterpret_cast<int*>(rsh + pad16(R))),
        bpo(bpo),
        G(G) {}

  __device__ __forceinline__ Cell load(int j) const {
    const int2 t = nnp[j];
    return {t.x, t.y, wp[j], 0};
  }
  // out of band: the init values, and no backpointers
  __device__ __forceinline__ void reset(int j, int nw, int n, int w) {
    nnp[j] = make_int2(nw, n);
    wp[j] = w;
    bprow[j] = 0;
  }
  __device__ __forceinline__ void put1(int j, const Cell&, const Cell&,
                                       int nw, int n, int nw_from,
                                       int n_from, int) {
    nnp[j] = make_int2(nw, n);
    bprow[j] = static_cast<uint8_t>(nw_from | (n_from << 2));
  }
  __device__ __forceinline__ int2 nn(int j) const { return nnp[j]; }
  __device__ __forceinline__ void put2(int j, int w, int w_from) {
    wp[j] = w;
    bprow[j] |= static_cast<uint8_t>(w_from << 4);
  }
  __device__ __forceinline__ void pick(int i, int j) {
    pk[0] = i;
    pk[1] = j;
    pk[2] = max(nnp[j].x, NEG);
    pk[3] = max(nnp[j].y, NEG);
    pk[4] = max(wp[j], NEG);
  }
  // the whole backpointer row (zero outside the band)
  __device__ __forceinline__ void end_row(int i, int lane) {
    uint8_t* dst = bpo + (size_t)i * G;
    if ((G & 15) == 0) {
      for (int q = lane; q < G / 16; q += 32)
        reinterpret_cast<int4*>(dst)[q] =
            reinterpret_cast<const int4*>(bprow)[q];
    } else {
      for (int j = lane; j < G; j += 32) dst[j] = bprow[j];
    }
  }
};

template <bool LOCAL, bool GLOBAL>
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
                  uint8_t* __restrict__ scratch, int B, int G, int R, int m,
                  int mm, int goa, int gea, int gob, int geb) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  // the pair's planes: shared memory, or (GLOBAL) its scratch
  uint8_t* base = GLOBAL ? scratch + (size_t)b * BpPlanes::bytes(G, R)
                         : reinterpret_cast<uint8_t*>(smem)
                               + (size_t)warp * BpPlanes::bytes(G, R);
  BpPlanes P(base, bp + (size_t)b * R * G, G, R);
  for (int j = lane; j < pad16(G); j += 32) P.bprow[j] = 0;
  if (lane == 0) {
    P.pk[0] = P.pk[1] = 0;
    P.pk[2] = P.pk[3] = P.pk[4] = NEG;
  }
  const banded::Pair p = {glen[b], rlen[b], ax[b], ay[b], alen[b], awid[b]};
  const banded::Costs c = {m, mm, goa, gea, gob, geb};
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* r = read + (size_t)b * R;
  // every row: the backpointers of rows past rlen are written too
  const int best =
      rev[b] != 0
          ? banded::dp<32, LOCAL>(P, lane, FULL_MASK, g, r, R, p, true, G, R,
                                  c)
          : banded::dp<32, LOCAL>(P, lane, FULL_MASK, g, r, R, p, false, G,
                                  R, c);
  if (lane == 0) {
    // _plane_from_stats
    const bool has = best > 0;
    st_out[b] = max(best, 0);
    st_out[B + b] = has ? P.pk[0] : 0;
    st_out[2 * B + b] = has ? P.pk[1] : 0;
    st_out[3 * B + b] =
        has ? banded::best_plane(P.pk[2], P.pk[3], P.pk[4]) : 0;
  }
}

// Pairs per block for a launch of B pairs of G columns: PAIRS when every
// SM still gets a block and PAIRS pairs' shared memory fits a block,
// else fewer (banded::prepare). `global`: one pair's planes do not fit
// a block (the GLOBAL instances, no dynamic shared memory).
cudaError_t prepare(int B, int G, int R, int* pairs, int* smem,
                    bool* global) {
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  *global = BpPlanes::bytes(G, R) > optin;
  int threads = 32;
  if (*global) {
    const decltype(&sw_full_bp_kernel<false, true>) ks[] = {
        sw_full_bp_kernel<false, true>, sw_full_bp_kernel<true, true>};
    e = banded::prepare(ks, B, 32, 32 * PAIRS, 0, &threads, smem);
  } else {
    const decltype(&sw_full_bp_kernel<false, false>) ks[] = {
        sw_full_bp_kernel<false, false>, sw_full_bp_kernel<true, false>};
    e = banded::prepare(ks, B, 32, 32 * PAIRS,
                        static_cast<int>(BpPlanes::bytes(G, R)), &threads,
                        smem);
  }
  *pairs = threads / 32;
  return e;
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, glen/rlen/ax/ay/alen/awid/rev [B]
// i32 -> st [4, B] i32 (score, max_i, max_j, plane), bp [B, R, G] u8,
// every byte written. goa/gea/gob/geb are the open and extend costs as
// positive penalties (open NOT including extend, as in sw_full_pallas).
// `scratch` is the device memory of sw_full_bp_scratch's size (null when
// that is 0). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for G < 1, or a null scratch where the launch
// needs one).
extern "C" int sw_full_bp_launch(const void* genome, const void* glen,
                                 const void* read, const void* rlen,
                                 const void* ax, const void* ay,
                                 const void* alen, const void* awid,
                                 const void* rev, void* st, void* bp, int B,
                                 int G, int R, int m, int mm, int goa,
                                 int gea, int gob, int geb, int local,
                                 void* stream, void* scratch) {
  if (B <= 0 || R <= 0) return 0;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  int pairs = 1, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (global && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = global ? (local ? sw_full_bp_kernel<true, true>
                                : sw_full_bp_kernel<false, true>)
                       : (local ? sw_full_bp_kernel<true, false>
                                : sw_full_bp_kernel<false, false>);
  kernel<<<(B + pairs - 1) / pairs, 32 * pairs, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), i32(glen),
      static_cast<const uint8_t*>(read), i32(rlen), i32(ax), i32(ay),
      i32(alen), i32(awid), i32(rev), static_cast<int32_t*>(st),
      static_cast<uint8_t*>(bp), static_cast<uint8_t*>(scratch), B, G, R, m,
      mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

// The device memory, in bytes, that a launch of B pairs of G columns and
// R rows needs beside its outputs, into *(long long*)out: the pairs'
// planes where one pair's do not fit a block's shared memory, else 0.
// Returns a cudaError_t.
extern "C" int sw_full_bp_scratch(int B, int G, int R, void* out) {
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (B <= 0 || G < 1 || R < 1) return 0;
  int pairs = 1, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (global) *o = BpPlanes::bytes(G, R) * B;
  return static_cast<int>(e);
}

// The launch configuration of B pairs of G columns and R rows (of the
// global-mode kernel, the main path's): out[0..5] = pairs per block, threads per
// pair, dynamic shared memory bytes per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread
// and local (spill) bytes per thread. Returns a cudaError_t.
extern "C" int sw_full_bp_config(int B, int G, int R, void* out) {
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int pairs = 1, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(global ? sw_full_bp_kernel<false, true>
                               : sw_full_bp_kernel<false, false>,
                        32, 32 * pairs, smem, static_cast<int*>(out));
}
