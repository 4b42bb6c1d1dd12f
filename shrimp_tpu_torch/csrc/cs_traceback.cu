// Colour-space traceback over the 4-layer DP's backpointers, hand-written
// for Hopper (sm_90a).
//
// Replaces: the on-device traceback shrimp_tpu/core/sw_cs_jax.py::
// _cs_traceback (a lax.scan of R + G gather steps, device code on the TPU
// though not a Pallas kernel). From the DP's best cell (bi, bj, bk, bfrm)
// it walks the packed backpointers (nw | n << 5 | w << 10, written by
// csrc/sw_cs_full.cu in the layout [B, R, 4, G]) back to the alignment's
// start, counting matches (BASE_N on either side matches), mismatches,
// insertions, deletions and crossovers, and emits one step code per op,
// op | layer << 2 | crossover << 4, last op first. An alignment that
// starts in a layer other than 0 gets a leading crossover on its first
// op. Outputs are bit-equal to _cs_traceback: packed [B, 12] int16
// (score, bi, bj, bk, nops, read start, genome start, matches,
// mismatches, insertions, deletions, crossovers) and steps_rev
// [B, R + G] int8.
//
// What bounds it on an H100: the latency of one walk. Each step's cell
// depends on the previous step's backpointer, so a walk is a chain of
// up to R + G dependent loads and decodes; the backpointers of a
// 2048-pair launch at (R, G) = (36, 64) are 37.7 MB, most of the L2, so
// a step that reads device memory waits for a round trip.
//
// What the design does about it:
// - A warp per pair, PAIRS pairs a block, halved while some SM would get
//   no block. A pair that does not walk (score below thresh, bfrm = 0)
//   copies nothing.
// - The walk is fed from shared memory. The warp stages the window, the
//   4 read layers and a band of backpointers around the walk's diagonal:
//   for each row i of the TH rows up to the walk's cell (ci, cj), the
//   PW columns (all 4 layers) from ((cj - (ci - i) - WL) & ~7), so a
//   walk whose deletions minus insertions stay within [-WL, PW - WL - 8]
//   never leaves it. Only that band is copied, with 16-byte cp.async
//   pieces, the window and the read layers with 4-byte ones, all in
//   flight at once (so G must be a multiple of 8, the backpointers
//   16-byte aligned and the window and layers 4-byte aligned; the launch
//   refuses other inputs). At the main shape the band holds every row of
//   the walk.
// - Lane 0 walks and writes the step codes to shared memory. A step is
//   one decode through a step table in a register (code -> op and the
//   plane the next read decodes) and a branch per exit. The three cells
//   the walk can move to, in the layer it moves into, are loaded while
//   the op decodes: a guard row above the band and guard columns left of
//   each band row keep those loads inside the buffer. A walk that leaves
//   the band (through its top, or sideways), or whose op does not move
//   it, has the warp copy a new band at its cell.
// - The warp writes the [R + G] step row, zero tail included, with
//   coalesced byte stores; the leading crossover is set in shared memory
//   first.
// - Any G: a pair's shared memory is the band (12.5 KB) plus 2G + 5R
//   bytes, which fits a block to about G + 2.5R = 110,000. Past that the
//   kernel's GLOBAL instance stages the band alone: the walk reads the
//   window and the layers where they lie and writes its step codes into
//   the output row, whose tail the warp then zeroes.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

constexpr int PAIRS = 4;   // warps, one pair each, per block (large B)
constexpr int TH = 64;     // rows of a band (fewer when R is smaller)
// columns of a band row, a multiple of 8: 16 was faster on the card than
// 24 and 32 (PERF.md); the diagonal's column sits WL..WL+7 into it
constexpr int PW = 16;
constexpr int WL = 4;
static_assert(PW % 8 == 0 && PW >= WL + 8, "band shape");
constexpr int NPC = PW / 8;   // 16-byte pieces of a band row of a layer
// a band row of one layer: 8 guard columns, then PW columns
constexpr int RS = PW + 8;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BASE_N = 15;
// The step table: nibble `code` (the direction-pair code of a from-code,
// sw-full-cs.c) holds op | plane << 2: op 0 none, 1 ins (W), 2 del (N),
// 3 match or mismatch (NW); the plane (0 nw, 1 n, 2 w) the next read
// decodes. Codes 1-2 are NN, NNW; 3-4 WNW, WW; 5-7 NWN, NWNW, NWW.
constexpr unsigned step_entry(int code, int op, int plane) {
  return static_cast<unsigned>(op | plane << 2) << (4 * code);
}
constexpr unsigned STEPS = step_entry(1, 2, 1) | step_entry(2, 2, 0)
                           | step_entry(3, 1, 0) | step_entry(4, 1, 2)
                           | step_entry(5, 3, 1) | step_entry(6, 3, 0)
                           | step_entry(7, 3, 2);

using banded::pad16;

// rows of a band for R rows
__host__ __device__ inline int band_rows(int R) { return R < TH ? R : TH; }
// int16 of a band buffer: a guard row and the band's rows, 4 layers of
// RS each, and 8 past the end for the look-ahead loads
__host__ __device__ inline int band_len(int R) {
  return (band_rows(R) + 1) * 4 * RS + 8;
}
// bytes of shared memory of one pair: the band, the window, the read
// layers and the step codes (the band alone where those do not fit a
// block: the walk then reads the window and the layers and writes the
// step codes in device memory)
__host__ __device__ inline long long pair_bytes(int G, int R) {
  return pad16(2 * band_len(R)) + (long long)pad16(G) + pad16(4 * R)
         + pad16(R + G);
}
__host__ __device__ inline int band_bytes(int R) {
  return pad16(2 * band_len(R));
}

// 16- and 4-byte copies from device to shared memory that do not pass
// through registers (cp.async); cp_async_wait waits for every copy this
// thread issued
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 4);
#endif
}
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The first column of row i of the band anchored at (ci, cj): never
// more than the walk's column in that row while it stays in the band,
// and one row up it is at most 8 columns less.
__device__ __forceinline__ int band_left(int ci, int cj, int i) {
  return max((cj - (ci - i) - WL) & ~7, 0);
}
// The band buffer's index of row r (of the band), layer k, column c
// (of the band row); r = -1 and c = -1 are guards.
__device__ __forceinline__ int band_at(int r, int k, int c) {
  return ((r + 1) * 4 + k) * RS + 8 + c;
}

// The warp copies rows [top, ci] of the band anchored at (ci, cj) from
// the pair's backpointers bpb ([R, 4, G] int16) into `band`, PW columns
// of each of the 4 layers a row, in 16-byte cp.async pieces (columns
// past G are not copied: G is a multiple of 8).
__device__ __forceinline__ void load_band(int16_t* band,
                                          const int16_t* __restrict__ bpb,
                                          int G, int top, int ci, int cj,
                                          int lane) {
  int n = (ci - top + 1) * 4 * NPC;
  // keep the loop bound opaque to the optimizer (the ptxas fold of
  // banded_sw.cuh)
  asm volatile("" : "+r"(n));
  for (int p = lane; p < n; p += 32) {
    const int r = p / (4 * NPC), q = p % (4 * NPC);
    const int k = q / NPC, col = band_left(ci, cj, top + r) + q % NPC * 8;
    if (col < G)
      cp_async16(band + band_at(r, k, q % NPC * 8),
                 bpb + ((size_t)(top + r) * 4 + k) * G + col);
  }
}

template <bool GLOBAL>
__global__ void __launch_bounds__(32 * PAIRS)
cs_traceback_kernel(const uint8_t* __restrict__ genome,
                    const uint8_t* __restrict__ qr,
                    const int32_t* __restrict__ best_,
                    const int32_t* __restrict__ bi_,
                    const int32_t* __restrict__ bj_,
                    const int32_t* __restrict__ bk_,
                    const int32_t* __restrict__ bfrm_,
                    const int16_t* __restrict__ bp,
                    const int32_t* __restrict__ thresh_,
                    int16_t* __restrict__ packed, int8_t* __restrict__ steps,
                    int B, int G, int R) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int W = R + G;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem)
                  + warp * (GLOBAL ? band_bytes(R) : pair_bytes(G, R));
  const int TR = band_rows(R);
  int16_t* band = reinterpret_cast<int16_t*>(base);
  int8_t* out = steps + (size_t)b * W;   // the step row
  // the window, the read layers [4, R] and the step codes: staged in
  // shared memory, or (GLOBAL) where they lie in device memory
  uint8_t* gst = base + band_bytes(R);
  uint8_t* qst = gst + pad16(G);
  const uint8_t* gsh = GLOBAL ? genome + (size_t)b * G : gst;
  const uint8_t* qsh = GLOBAL ? qr + (size_t)b * 4 * R : qst;
  int8_t* ssh = GLOBAL ? out : reinterpret_cast<int8_t*>(qst + pad16(4 * R));
  const int16_t* bpb = bp + (size_t)b * R * 4 * G;
  const int best = best_[b];
  const int score = best >= thresh_[b] ? best : 0;
  const int bi = bi_[b], bj = bj_[b], bk = bk_[b], bfrm = bfrm_[b];
  // lane 0's walk state; every lane keeps the band's anchor
  int i = bi, j = bj, k = bk;
  int rs = 0, gs = 0, nm = 0, nmm = 0, ins = 0, del = 0, xo = 0, nops = 0;
  if (bfrm != 0 && score > 0) {
    // the band anchored at the walk's cell (clamped: the plain version
    // clamps the row and column it reads), rows [top, ci]
    int ci = min(max(i, 0), R - 1), cj = min(max(j, 0), G - 1);
    int top = max(ci - (TR - 1), 0);
    load_band(band, bpb, G, top, ci, cj, lane);
    // the window and the read layers, in 4-byte pieces (G is a multiple
    // of 8; the launch refuses genome and qr off a 4-byte boundary)
    if (!GLOBAL) {
      for (int c = 4 * lane; c < G; c += 128)
        cp_async4(gst + c, genome + (size_t)b * G + c);
      for (int c = 4 * lane; c < 4 * R; c += 128)
        cp_async4(qst + c, qr + (size_t)b * 4 * R + c);
    }
    cp_async_wait();
    __syncwarp();
    // the from-code of the walk's cell, its direction-pair code clamped
    // as the plain version clamps it (a code past 7 steps as 7); the
    // first is bfrm, every later one 5 bits read from the band
    int f = min(max(bfrm >> 2, 0), 7) << 2 | (bfrm & 3);
    int q5 = 0;             // the read's field shift, 5 x its plane
    bool pending = false;   // f is still to be read at (i, j, k)
    bool done = false;
    for (;;) {
      bool reload = false;
      if (lane == 0) {
        if (pending) {   // the first read in a new band
          const int ic = min(i, R - 1), jc = min(j, G - 1);
          f = (band[band_at(ic - top, k, jc - band_left(ci, cj, ic))] >> q5)
              & 31;
          pending = false;
          done = f == 0;
        }
        while (!done) {
          const int lyr = f & 3;
          const int e = static_cast<int>(STEPS >> (4 * (f >> 2))) & 15;
          const int op = e & 3;
          // the cells the walk can move to, in layer lyr: up, left and
          // up-left, loaded while the op decodes (a start at a negative
          // row or column reads row or column 0 and stops after one
          // step, as in the plain version, so it looks ahead from 0)
          const int i0 = max(i, 0), j0 = max(j, 0);
          const int ic = min(i0, R - 1), iu = min(i0 - 1, R - 1);
          const int jc = min(j0, G - 1), jl = min(j0 - 1, G - 1);
          const int lu = band_left(ci, cj, iu);
          const int vn = band[band_at(iu - top, lyr, jc - lu)];
          const int vw = band[band_at(ic - top, lyr,
                                      jl - band_left(ci, cj, ic))];
          const int vd = band[band_at(iu - top, lyr, jl - lu)];
          del += op == 2;
          ins += op == 1;
          const int gch = gsh[jc];
          const int rch = qsh[min(max(k, 0), 3) * R + ic];
          const bool okm = gch == rch || gch == BASE_N || rch == BASE_N;
          nm += op == 3 && okm;
          nmm += op == 3 && !okm;
          if (op >= 2) rs = i;
          if (op & 1) gs = j;
          const bool xov = lyr != k;
          xo += xov;
          ssh[nops] = (int8_t)(op | k << 2 | (xov ? 16 : 0));
          k = lyr;
          ++nops;
          const int di = op >> 1, dj = op & 1;
          i -= di;
          j -= dj;
          if (i < 0 || j < 0 || nops >= W) {
            done = true;
            break;
          }
          q5 = 5 * (e >> 2);
          // the new cell in the band: rows [top, ci], PW columns a row
          const int r = (di ? iu : ic) - top;
          const int c = (dj ? jl : jc) - (di ? lu : band_left(ci, cj, ic));
          if (op == 0 || r < 0 || c < 0 || c >= PW) {
            pending = true;   // a new band at the walk's cell
            reload = true;
            break;
          }
          f = ((op == 3 ? vd : op == 2 ? vn : vw) >> q5) & 31;
          if (f == 0) {
            done = true;
            break;
          }
        }
      }
      if (!__shfl_sync(FULL_MASK, reload, 0)) break;
      ci = min(__shfl_sync(FULL_MASK, i, 0), R - 1);
      cj = min(__shfl_sync(FULL_MASK, j, 0), G - 1);
      top = max(ci - (TR - 1), 0);
      __syncwarp();
      load_band(band, bpb, G, top, ci, cj, lane);
      cp_async_wait();
      __syncwarp();
    }
    // leading crossover when the alignment starts in a layer other than 0
    if (lane == 0 && k != 0 && nops > 0) {
      ssh[nops - 1] |= 16;
      ++xo;
    }
    nops = __shfl_sync(FULL_MASK, nops, 0);
    __syncwarp();
  }
  // the step row, the walk's codes then zeros (GLOBAL: the codes are in
  // place)
  for (int s = GLOBAL ? nops + lane : lane; s < W; s += 32)
    out[s] = s < nops ? ssh[s] : 0;
  if (lane == 0) {
    int16_t* p = packed + (size_t)b * 12;
    const int vals[12] = {score, bi, bj, bk, nops, rs, gs, nm, nmm, ins,
                          del, xo};
#pragma unroll
    for (int c = 0; c < 12; ++c) p[c] = (int16_t)vals[c];
  }
}

// Threads per block for a launch of B pairs: a warp per pair, PAIRS warps
// halved (down to one) while some SM would get no block or the pairs'
// shared memory does not fit a block; sets the kernel's dynamic shared
// memory limit when above 48 KB. `global`: one pair's window, read
// layers and step codes do not fit a block (the GLOBAL kernel).
cudaError_t prepare(int B, int G, int R, int* threads, int* smem,
                    bool* global) {
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  *global = pair_bytes(G, R) > optin;
  if (*global) {
    const decltype(&cs_traceback_kernel<true>) ks[] = {
        cs_traceback_kernel<true>};
    return banded::prepare(ks, B, 32, 32 * PAIRS, band_bytes(R), threads,
                           smem);
  }
  const decltype(&cs_traceback_kernel<false>) ks[] = {
      cs_traceback_kernel<false>};
  return banded::prepare(ks, B, 32, 32 * PAIRS,
                         static_cast<int>(pair_bytes(G, R)), threads, smem);
}

}  // namespace

// genome [B, G] u8 (letters), qr [B, 4, R] u8, best/bi/bj/bk/bfrm/thresh
// [B] i32, bp [B, R, 4, G] i16 -> packed [B, 12] i16, steps
// [B, R + G] i8. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue when G is not a multiple of 8, bp is not
// 16-byte aligned or genome and qr are not 4-byte aligned: the bands
// load in 16-byte pieces, the window and the read layers in 4-byte
// ones).
extern "C" int cs_traceback_launch(const void* genome, const void* qr,
                                   const void* best, const void* bi,
                                   const void* bj, const void* bk,
                                   const void* bfrm, const void* bp,
                                   const void* thresh, void* packed,
                                   void* steps, int B, int G, int R,
                                   void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || R < 1 || (G & 7) != 0
      || (reinterpret_cast<uintptr_t>(bp) & 15) != 0
      || ((reinterpret_cast<uintptr_t>(genome)
           | reinterpret_cast<uintptr_t>(qr)) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = 32, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &threads, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = threads / 32;
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = global ? cs_traceback_kernel<true>
                       : cs_traceback_kernel<false>;
  kernel<<<(B + pairs - 1) / pairs, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), static_cast<const uint8_t*>(qr),
      i32(best), i32(bi), i32(bj), i32(bk), i32(bfrm),
      static_cast<const int16_t*>(bp), i32(thresh),
      static_cast<int16_t*>(packed), static_cast<int8_t*>(steps), B, G, R);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration of B pairs of G columns and R rows:
// banded::config's six values. Returns a cudaError_t.
extern "C" int cs_traceback_config(int B, int G, int R, void* out) {
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 32, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &threads, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(global ? cs_traceback_kernel<true>
                               : cs_traceback_kernel<false>,
                        32, threads, smem, static_cast<int*>(out));
}
