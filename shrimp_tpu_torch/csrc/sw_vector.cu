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
// 3000 bp; any G) take a second kernel that runs the same wavefront over
// column tiles. A tile is 32 lanes x WIDE_S columns, its H, F, window
// bytes (and row-0 colours) and column masks in registers; all rows of
// the pair stream through the tile's wavefront, with the narrow kernel's
// cell arithmetic in the same order. The row loop carries exactly two
// values across a tile border, c and the H of the tile's last column:
// lane 31 writes them for each row into an edge buffer of R x (c, H),
// and lane 0 of the next tile reads them. A pair has W warps (a power of
// two up to WIDE_WARPS, from B and G: more while the launch leaves SMs
// without warps); warp w takes tiles w, w + W, ... and runs behind the
// warp to its left, each warp writing its own edge buffer and publishing
// the rows it has written every ROWS_STEP steps (a counter in shared
// memory that the next warp's lane 0 waits on). With one warp, one buffer
// serves every tile: lane 0 reads row t at step t, one step before lane
// 31 writes row t - 31 of the same tile. The buffers, 8 W R bytes a
// pair, sit in shared memory while they fit a block and in a
// device-memory scratch past that. Tiles wholly past glen and rows past
// rlen are skipped; the pad column's 0 and FILL enter at tile 0, lane 0.
// A cell costs registers and DPX only; the working set does not grow
// with G.
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

// ---- windows wider than 256: the tiled kernel

// columns a lane of a tile: 352 columns a tile, which divides the G
// buckets of 250, 1000 and 3000 bp reads (352, 1408, 4224)
constexpr int WIDE_S = 11;
constexpr int TILE = 32 * WIDE_S;       // columns a tile
constexpr int WIDE_WARPS = 8;           // most warps a pair
constexpr int ROWS_STEP = 32;           // steps between edge publications
constexpr int WIDE_STATIC = 2 * WIDE_WARPS * 4;   // static shared bytes

// Spins until *flag >= target, then orders the loads after it (the
// counter's writer fences before its store).
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  while (*reinterpret_cast<const volatile int*>(flag) < target) {
  }
  __threadfence_block();
}

__device__ __forceinline__ void store_flag(int* flag, int v) {
  __threadfence_block();
  *reinterpret_cast<volatile int*>(flag) = v;
}

// GLOBAL: the edge buffers in scratch (W * R int2 a pair), else in
// dynamic shared memory. A block is one pair, blockDim.x / 32 = W warps.
template <bool GLOBAL>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
sw_vector_wide_kernel(const uint8_t* __restrict__ genome,
                      const uint8_t* __restrict__ g_row0,
                      const int32_t* __restrict__ glen,
                      const uint8_t* __restrict__ read,
                      const int32_t* __restrict__ rlen,
                      int32_t* __restrict__ out, int2* scratch, int G,
                      int R, int m, int mm, int goa, int gea, int gob,
                      int geb) {
  constexpr int S = WIDE_S;
  extern __shared__ int4 smem[];
  // rows of (c, H) each warp has published, counted over its tiles; the
  // warps' best scores
  __shared__ int done[WIDE_WARPS];
  __shared__ int wbest[WIDE_WARPS];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  int2* edges = GLOBAL ? scratch + (size_t)b * W * R
                       : reinterpret_cast<int2*>(smem);
  int2* mine = edges + (size_t)warp * R;   // lane 31 writes this warp's
  const int pw = warp == 0 ? W - 1 : warp - 1;   // the tile to the left's
  const int2* left = edges + (size_t)pw * R;
  const int nj = min(glen[b], G);
  const int ni = min(rlen[b], R);
  // tiles below glen; the bounds pass through the empty asm statement
  // (the ptxas min/max fold of banded_sw.cuh)
  int ntiles = ni > 0 ? (nj + TILE - 1) / TILE : 0;
  asm volatile("" : "+r"(ntiles));
  if (lane == 0) done[warp] = 0;
  __syncthreads();

  const uint8_t* gp = genome + (size_t)b * G;
  const uint8_t* g0p = g_row0 != nullptr ? g_row0 + (size_t)b * G : nullptr;
  const uint8_t* rd = read + (size_t)b * R;
  const int T = ni + 31;   // steps of a tile's wavefront
  int best = 0;
  for (int tile = warp, ord = 0; tile < ntiles; tile += W, ++ord) {
    const int j0 = tile * TILE + lane * S;
    int nv = min(max(nj - j0, 0), S);
    asm volatile("" : "+r"(nv));
    int h[S], f[S], gw[S], gc[S], mk[S], jg[S], ej[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = j0 + k;
      h[k] = 0;
      f[k] = NEG;
      gw[k] = j < G ? gp[j] : 0;
      // colour space: row 0 compares against g_row0
      gc[k] = j < G && g0p != nullptr ? g0p[j] : gw[k];
      mk[k] = k < nv ? 0 : NEG;       // best takes H + mk: columns past
                                      // glen stay below 0
      jg[k] = j * gea;                // h0 + j*gea enters the E chain
      ej[k] = -(goa - gea) - j * gea; // E of column j is c + ej
    }
    // the left tile's warp has published `base` rows before this tile's
    // (it is that warp's ord-th tile, warp 0's (ord-1)-th)
    const int base = (warp == 0 ? ord - 1 : ord) * ni;
    int rch = rd[0];
    int cout = FILL, hout = 0;   // c and H at the strip's end, last row
    int hup = 0;                 // H[i-1][j0-1]
    for (int t = 0; t < T; ++t) {
      if (tile > 0 && t < ni && t % ROWS_STEP == 0) {
        // lane 0 reads rows t .. t + ROWS_STEP - 1 of the left tile next
        if (lane == 0) wait_flag(done + pw, base + min(t + ROWS_STEP, ni));
        __syncwarp();
      }
      int cin = __shfl_up_sync(FULL_MASK, cout, 1);
      int hin = __shfl_up_sync(FULL_MASK, hout, 1);
      if (lane == 0) {
        if (tile == 0) {   // the row starts here: no E chain, the pad column
          cin = FILL;
          hin = 0;
        } else if (t < ni) {
          const int2 e = left[t];
          cin = e.x;
          hin = e.y;
        }
      }
      const int i = t - lane;
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
          best = __viaddmax_s32(hj, mk[k], best);
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
        if (lane == 31) mine[i] = make_int2(cout, hout);
      }
      hup = hin;
      // lane 31 has written rows 0 .. t - 31 of this tile
      if (lane == 31 && ((t + 1) % ROWS_STEP == 0 || t + 1 == T))
        store_flag(done + warp, ord * ni + min(max(t - 30, 0), ni));
    }
  }
  best = __reduce_max_sync(FULL_MASK, best);
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < W; ++w) best = max(best, wbest[w]);
    out[b] = best;
  }
}

// The tiled kernel's launch for B pairs of G columns and R rows: its
// warps a pair W (the largest power of two up to WIDE_WARPS and the tile
// count with B * W <= 8 warps an SM: small launches spread a pair over
// warps, a launch that fills the card keeps one), its dynamic shared
// memory, and whether the edge buffers go to device memory (they do not
// fit a block); sets the shared memory limit above 48 KB.
cudaError_t wide_prepare(int B, int G, int R, int* warps, int* smem,
                         bool* global) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  const int ntiles = (G + TILE - 1) / TILE;
  int w = 1;
  while (2 * w <= WIDE_WARPS && 2 * w <= ntiles
         && 2LL * w * B <= 8LL * sms)
    w *= 2;
  *warps = w;
  const long long bytes = 8LL * w * R;
  *global = bytes + WIDE_STATIC > optin;
  *smem = *global ? 0 : static_cast<int>(bytes);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sw_vector_wide_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
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
// windows the tiled kernel; `scratch` is the device memory of
// sw_vector_scratch's size (null when that is 0). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for G < 1,
// or a null scratch where the tiled kernel needs one).
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
  int warps = 1, smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(B, G, R, &warps, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (global && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = global ? sw_vector_wide_kernel<true>
                       : sw_vector_wide_kernel<false>;
  kernel<<<B, 32 * warps, smem, st>>>(
      static_cast<const uint8_t*>(genome),
      static_cast<const uint8_t*>(g_row0),
      static_cast<const int32_t*>(glen), static_cast<const uint8_t*>(read),
      static_cast<const int32_t*>(rlen), static_cast<int32_t*>(out),
      static_cast<int2*>(scratch), G, R, m, mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

// The device memory, in bytes, that a launch of B pairs of G columns
// and R rows needs beside its output, into *(long long*)out: the tiled
// kernel's edge buffers (8 bytes a row, a buffer a warp) where they do
// not fit a block's shared memory, else 0. Returns a cudaError_t.
extern "C" int sw_vector_scratch(int B, int G, int R, void* out) {
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (G <= 256 || B <= 0) return 0;
  int warps = 1, smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(B, G, R, &warps, &smem, &global);
  if (global) *o = 8LL * warps * R * B;
  return static_cast<int>(e);
}

// The launch configuration of B pairs of G columns and R rows (the
// signature is every <kernel>_config's): out[0..5] = pairs per block,
// threads per pair, dynamic shared memory bytes per block, resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers per thread and local (spill) bytes per thread, of the kernel
// that sw_vector_launch takes for G. Returns a cudaError_t.
extern "C" int sw_vector_config(int B, int G, int R, void* out) {
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  if (G <= 64) return narrow_config<64, LANES_64>(B, o);
  if (G <= 128) return narrow_config<128, LANES_128>(B, o);
  if (G <= 256) return narrow_config<256, LANES_256>(B, o);
  int warps = 1, smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(B, G, R, &warps, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(global ? sw_vector_wide_kernel<true>
                               : sw_vector_wide_kernel<false>,
                        32 * warps, 32 * warps, smem, o);
}
