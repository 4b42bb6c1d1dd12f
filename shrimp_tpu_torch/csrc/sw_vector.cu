// Vector Smith-Waterman (filter 2), hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel shrimp_tpu/core/sw_pallas.py::_kernel,
// reached through sw_vector_batch_pallas, in both modes. Scores are
// bit-equal to it and to the XLA formulation sw_jax.sw_vector_batch:
// local affine SW, gap open charged as open + extend, H clamped at 0,
// cells with i >= rlen or j >= glen contribute 0. In colour-space mode
// (g_row0 not null) read row 0 is scored against g_row0, the colours
// lstocs(genome letter, initbp), and every other row against the colour
// window (sw_pallas.py:81-83, sw_jax.py:89-93).
//
// What bounds it on an H100: integer ALU and the chain of a row. A DP
// cell costs about ten int32 operations (adds and maxes) and a launch
// computes up to B*R*G cells, while device memory supplies only the
// window and read bytes of each pair; inside a row, each column's E gap
// depends on the column before it.
//
// What the design does about it, for windows of G <= 256: a segment of
// L lanes per (window, read) pair, several pairs to a warp. Lane l owns
// the S = GMAX / L consecutive columns [l*S, l*S + S) of the G bucket
// GMAX, and S is a compile-time constant, so its strip of the previous
// row's H and F and its window bytes (and, in colour space, its row-0
// colours) live in registers. The segment sweeps an anti-diagonal
// wavefront: at step t lane l scores row i = t - l over its strip with
// the recurrence of the plain loop, cell by cell in column order. From
// lane l - 1 it takes, by a shuffle, the two values the row loop carries
// into the strip: c, the running max of h0[k] + k*gea over the columns
// left of it in row i, and H[i][l*S - 1]; what it took one step earlier,
// H[i-1][l*S - 1], is its diagonal. Lane 0 takes FILL and the pad
// column's 0. A pair takes rlen + L - 1 steps of S cells, where one
// thread would take rlen * glen cells in a row, with the same arithmetic
// in the same order, so the scores stay bit-equal. Hopper's DPX
// add-max instructions (__viaddmax_s32, __viaddmax_s32_relu) do an add
// and a max of a cell in one. Columns at or past glen score but never
// reach the best (a mask per column: they lie right of every column that
// counts, so they feed only each other); lanes wholly past glen and rows
// at or past rlen skip their step; the warp runs to its longest pair.
// The read byte of the next row is loaded one step ahead. Blocks hold up
// to 128 threads, halved while some SM would get no block.
//
// Windows wider than 256 (long reads: G = 352 at 250 bp, 4224 at
// 3000 bp; any G) take a second kernel, one warp per pair, because
// their rows do not fit a segment's registers and a launch of a few
// hundred long pairs needs all the lanes it can get. Lane l owns a
// strip of S consecutive columns (S odd: distinct shared-memory banks);
// the previous row's H and F and the genome window sit in shared memory,
// 9 bytes a column, up to about 25,800 columns (the 227 KB a block can
// opt into); past that H and F sit in a device-memory scratch that the
// caller allocates and the window is read where it lies.
// A row runs in two passes over each strip: (1) h0 = max(0, H diagonal
// + s, F) and the strip's maximum of the E chain terms h0[k] + k*gea
// (each lane reads its left neighbour's diagonal H before any lane
// writes), combined across lanes by a 5-step __shfl_up_sync max scan;
// (2) E and H from the scanned carry.
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
constexpr int THREADS = 128;   // threads per block of the narrow kernel
constexpr unsigned FULL_MASK = 0xffffffffu;
// lanes per pair of each G bucket: S = GMAX / L = 8 columns a lane, in
// both modes (8 columns a lane beat 4 and 16 on the card: PERF.md)
constexpr int LANES_64 = 8, LANES_128 = 16, LANES_256 = 32;

template <int GMAX, int L>
__global__ void __launch_bounds__(THREADS)
sw_vector_kernel(const uint8_t* __restrict__ genome,
                 const uint8_t* __restrict__ g_row0,
                 const int32_t* __restrict__ glen,
                 const uint8_t* __restrict__ read,
                 const int32_t* __restrict__ rlen,
                 int32_t* __restrict__ out, int B, int G, int R, int m,
                 int mm, int goa, int gea, int gob, int geb) {
  constexpr int S = GMAX / L;
  static_assert(S * L == GMAX && (L & (L - 1)) == 0 && L <= 32, "lanes");
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = tid / L, l = tid % L;
  const bool live = b < B;   // a segment past B runs no step
  const int nj = live ? min(glen[b], G) : 0;
  const int ni = live ? min(rlen[b], R) : 0;
  const int j0 = l * S;
  // columns of the strip below glen; steps this lane needs (rows 0 ..
  // ni - 1 at steps l .. l + ni - 1), and the warp's count of steps.
  // Both pass through the empty asm statement: ptxas 12.8/12.9 folds
  // min/max bounds wrongly (banded_sw.cuh)
  int nv = min(max(nj - j0, 0), S);
  int T = nv > 0 && ni > 0 ? ni + l : 0;
  asm volatile("" : "+r"(nv), "+r"(T));
  T = __reduce_max_sync(FULL_MASK, T);

  const uint8_t* gp = genome + (size_t)b * G;
  const uint8_t* rd = read + (size_t)b * R;
  int h[S], f[S], gw[S], gc[S], mk[S], jg[S], ej[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    // the window's bytes up to G, loaded while glen and rlen are (the
    // columns at or past glen are masked)
    const int j = j0 + k;
    h[k] = 0;
    f[k] = NEG;
    gw[k] = live && j < G ? gp[j] : 0;
    // colour space: row 0 compares against g_row0
    gc[k] = live && j < G && g_row0 != nullptr ? g_row0[(size_t)b * G + j]
                                                : gw[k];
    mk[k] = k < nv ? -1 : 0;
    jg[k] = j * gea;                // h0 + j*gea enters the E chain
    ej[k] = -(goa - gea) - j * gea; // E of column j is c + ej
  }
  int rch = live && R > 0 ? rd[0] : 0;   // the read byte of this row
  int best = 0;
  int cout = FILL, hout = 0;   // c and H at the strip's end, last row
  int hup = 0;                 // H[i-1][j0-1], from the lane to the left
  for (int t = 0; t < T; ++t) {
    int cin = __shfl_up_sync(FULL_MASK, cout, 1, L);
    int hin = __shfl_up_sync(FULL_MASK, hout, 1, L);
    if (l == 0) {   // the row starts here: no E chain, the pad column
      cin = FILL;
      hin = 0;
    }
    const int i = t - l;
    if (i >= 0 && i < ni && nv > 0) {
      int hdiag = hup, c = cin;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int hp = h[k];
        const int fj = __viaddmax_s32(hp, -gob, f[k] - geb);
        const int s = gc[k] == rch ? m : mm;
        const int h0 = __viaddmax_s32_relu(hdiag, s, fj);
        const int hj = __viaddmax_s32(c, ej[k], h0);
        c = __viaddmax_s32(h0, jg[k], c);
        best = max(best, hj & mk[k]);
        hdiag = hp;
        h[k] = hj;
        f[k] = fj;
      }
      cout = c;
      hout = h[S - 1];
      if (i == 0) {
#pragma unroll
        for (int k = 0; k < S; ++k) gc[k] = gw[k];
      }
      if (i + 1 < ni) rch = rd[i + 1];
    }
    hup = hin;
  }
#pragma unroll
  for (int d = L / 2; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(FULL_MASK, best, d, L));
  if (live && l == 0) out[b] = best;
}

// max over the values of the lanes below this one (FILL for lane 0)
__device__ __forceinline__ int warp_exclusive_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v = max(v, u);
  }
  const int ex = __shfl_up_sync(FULL_MASK, v, 1);
  return lane == 0 ? FILL : ex;
}

// bytes of dynamic shared memory of the wide kernel: H, F, the window
inline long long wide_smem(int G) {
  return 8LL * G + ((G + 15) & ~15);
}

// GLOBAL: H and F in scratch (2G int32 a pair), the window read in place
template <bool GLOBAL>
__global__ void __launch_bounds__(32)
sw_vector_wide_kernel(const uint8_t* __restrict__ genome,
                      const uint8_t* __restrict__ g_row0,
                      const int32_t* __restrict__ glen,
                      const uint8_t* __restrict__ read,
                      const int32_t* __restrict__ rlen,
                      int32_t* __restrict__ out, int* __restrict__ scratch,
                      int G, int R, int m, int mm, int goa, int gea, int gob,
                      int geb) {
  extern __shared__ int4 smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  // H and F of the previous row, and the window
  int* h = GLOBAL ? scratch + (size_t)b * 2 * G : reinterpret_cast<int*>(smem);
  int* f = h + G;
  uint8_t* gst = reinterpret_cast<uint8_t*>(f + G);
  const uint8_t* gsh = GLOBAL ? genome + (size_t)b * G : gst;
  const int nj = min(glen[b], G);
  const int ni = min(rlen[b], R);
  for (int j = lane; j < nj; j += 32) {
    h[j] = 0;
    f[j] = NEG;
    if (!GLOBAL) gst[j] = genome[(size_t)b * G + j];
  }
  __syncwarp();
  const int S = ((nj + 31) / 32) | 1;
  int j0 = min(lane * S, nj), j1 = min(j0 + S, nj);
  // keep the strip bounds opaque to the optimizer (the ptxas min/max
  // fold of banded_sw.cuh)
  asm volatile("" : "+r"(j0), "+r"(j1));
  const uint8_t* rd = read + (size_t)b * R;
  int best = 0;
  for (int i = 0; i < ni; ++i) {
    const int rch = rd[i];
    // colour space: row 0 compares against g_row0
    const uint8_t* row0 = (i == 0 && g_row0 != nullptr)
                              ? g_row0 + (size_t)b * G : nullptr;
    // H[i-1][j0-1], read before the lane to the left overwrites it; the
    // j = -1 pad column is always 0
    int hdiag = (j0 > 0 && j0 < j1) ? h[j0 - 1] : 0;
    __syncwarp();
    int agg = FILL;
    for (int j = j0; j < j1; ++j) {
      const int hp = h[j];
      const int fj = max(hp - gob, f[j] - geb);
      const int gch = row0 != nullptr ? row0[j] : gsh[j];
      const int s = gch == rch ? m : mm;
      const int h0 = max(max(0, hdiag + s), fj);
      agg = max(agg, h0 + j * gea);
      hdiag = hp;
      h[j] = h0;
      f[j] = fj;
    }
    // running max of h0[k] + k*gea over the columns left of the strip
    int c = warp_exclusive_max(agg, lane);
    for (int j = j0; j < j1; ++j) {
      const int h0 = h[j];
      const int e = c - (goa - gea) - j * gea;
      const int hj = max(h0, e);
      c = max(c, h0 + j * gea);
      best = max(best, hj);
      h[j] = hj;
    }
    __syncwarp();
  }
  best = __reduce_max_sync(FULL_MASK, best);
  if (lane == 0) out[b] = best;
}

// Threads per block of the narrow kernel for B pairs of L lanes: THREADS,
// halved (down to one warp) while some SM would get no block.
template <int GMAX, int L>
cudaError_t narrow_threads(int B, int* threads) {
  const decltype(&sw_vector_kernel<GMAX, L>) ks[] = {
      sw_vector_kernel<GMAX, L>};
  int smem = 0;
  return banded::prepare(ks, B, L, THREADS, 0, threads, &smem);
}

template <int GMAX, int L>
int launch(const void* genome, const void* g_row0, const void* glen,
           const void* read, const void* rlen, void* out, int B, int G,
           int R, int m, int mm, int goa, int gea, int gob, int geb,
           cudaStream_t stream) {
  int threads = THREADS;
  const cudaError_t e = narrow_threads<GMAX, L>(B, &threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)B * L;
  sw_vector_kernel<GMAX, L><<<(int)((n + threads - 1) / threads), threads, 0,
                              stream>>>(
      static_cast<const uint8_t*>(genome),
      static_cast<const uint8_t*>(g_row0), static_cast<const int32_t*>(glen),
      static_cast<const uint8_t*>(read), static_cast<const int32_t*>(rlen),
      static_cast<int32_t*>(out), B, G, R, m, mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel's dynamic shared memory for windows G wide, and
// whether H and F go to device memory (they do not fit a block); sets the
// shared memory limit above 48 KB.
cudaError_t wide_prepare(int G, int* smem, bool* global) {
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  *global = wide_smem(G) > optin;
  *smem = *global ? 0 : static_cast<int>(wide_smem(G));
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sw_vector_wide_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <int GMAX, int L>
int narrow_config(int B, int* o) {
  int threads = THREADS;
  const cudaError_t e = narrow_threads<GMAX, L>(B, &threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(sw_vector_kernel<GMAX, L>, L, threads, 0, o);
}

}  // namespace

// genome [B, G] u8, g_row0 [B, G] u8 or null (letter space), glen [B]
// i32, read [B, R] u8, rlen [B] i32 -> out [B] i32. goa/gob are open +
// extend costs and gea/geb extend costs, all as positive penalties.
// G <= 256 takes the narrow kernel (a segment of lanes per pair), wider
// windows the warp-per-pair kernel; `scratch` is the device memory of
// sw_vector_scratch's size (null when that is 0). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for G < 1,
// or a null scratch where the wide kernel needs one).
extern "C" int sw_vector_launch(const void* genome, const void* g_row0,
                                const void* glen, const void* read,
                                const void* rlen, void* out, int B, int G,
                                int R, int m, int mm, int goa, int gea,
                                int gob, int geb, void* stream,
                                void* scratch) {
  if (B <= 0) return 0;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 64)
    return launch<64, LANES_64>(genome, g_row0, glen, read, rlen, out, B, G,
                                R, m, mm, goa, gea, gob, geb, st);
  if (G <= 128)
    return launch<128, LANES_128>(genome, g_row0, glen, read, rlen, out, B,
                                  G, R, m, mm, goa, gea, gob, geb, st);
  if (G <= 256)
    return launch<256, LANES_256>(genome, g_row0, glen, read, rlen, out, B,
                                  G, R, m, mm, goa, gea, gob, geb, st);
  int smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(G, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (global && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = global ? sw_vector_wide_kernel<true>
                       : sw_vector_wide_kernel<false>;
  kernel<<<B, 32, smem, st>>>(
      static_cast<const uint8_t*>(genome),
      static_cast<const uint8_t*>(g_row0),
      static_cast<const int32_t*>(glen), static_cast<const uint8_t*>(read),
      static_cast<const int32_t*>(rlen), static_cast<int32_t*>(out),
      static_cast<int*>(scratch), G, R, m, mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

// The device memory, in bytes, that a launch of B pairs of G columns
// needs beside its output, into *(long long*)out: the wide kernel's H
// and F where they do not fit a block's shared memory, else 0. (R is
// not read.) Returns a cudaError_t.
extern "C" int sw_vector_scratch(int B, int G, int R, void* out) {
  (void)R;
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (G <= 256 || B <= 0) return 0;
  int smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(G, &smem, &global);
  if (global) *o = 8LL * G * B;
  return static_cast<int>(e);
}

// The launch configuration of B pairs of G columns (R is not read; the
// signature is every <kernel>_config's): out[0..5] = pairs per block,
// threads per pair, dynamic shared memory bytes per block, resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers per thread and local (spill) bytes per thread, of the
// kernel that sw_vector_launch takes for G. Returns a cudaError_t.
extern "C" int sw_vector_config(int B, int G, int R, void* out) {
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  if (G <= 64) return narrow_config<64, LANES_64>(B, o);
  if (G <= 128) return narrow_config<128, LANES_128>(B, o);
  if (G <= 256) return narrow_config<256, LANES_256>(B, o);
  int smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(G, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(global ? sw_vector_wide_kernel<true>
                               : sw_vector_wide_kernel<false>,
                        32, 32, smem, o);
}
