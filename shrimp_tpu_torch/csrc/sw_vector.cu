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
// What bounds it on an H100: integer ALU. A DP cell costs about ten
// int32 operations (compare, adds, maxes) and a launch computes B*R*G
// cells, while device memory supplies only the window and read bytes of
// each pair: a few bytes per cell at most, and L1/L2 serve the repeats.
//
// What the simple design does about it: one thread per (window, read)
// pair, the inter-task layout the TPU kernel used with one lane per
// pair, so no thread waits on another. The thread walks rows i and,
// inside a row, columns j in order; the E-gap chain that the TPU kernel
// resolves with a log-doubling cummax is then a scalar carried along j.
// The previous row's H and F live in per-thread arrays sized by the G
// bucket (a template parameter), in local memory that L1 caches. Rows
// i >= rlen and columns j >= glen score 0 in the reference, so the
// loops stop there. Blocks are small (64 threads) so that the main
// path's 8192-pair launches spread over all 132 SMs.
//
// Windows wider than 256 (long reads: G = 352 at 250 bp, up to 4095 in
// the packed flow) take a second kernel, one warp per pair, because a
// thread per pair would keep G-wide rows in local memory and leave a
// launch of a few hundred long pairs on a handful of SMs. Lane l owns a
// strip of S consecutive columns (S odd: distinct shared-memory banks);
// the previous row's H and F and the genome window sit in shared memory.
// A row runs in two passes over each strip: (1) h0 = max(0, H diagonal
// + s, F) and the strip's maximum of the E chain terms h0[k] + k*gea
// (each lane reads its left neighbour's diagonal H before any lane
// writes), combined across lanes by a 5-step __shfl_up_sync max scan;
// (2) E and H from the scanned carry.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int FILL = -(1 << 28);
constexpr int BLOCK = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int GMAX>
__global__ void __launch_bounds__(BLOCK)
sw_vector_kernel(const uint8_t* __restrict__ genome,
                 const uint8_t* __restrict__ g_row0,
                 const int32_t* __restrict__ glen,
                 const uint8_t* __restrict__ read,
                 const int32_t* __restrict__ rlen,
                 int32_t* __restrict__ out, int B, int G, int R, int m,
                 int mm, int goa, int gea, int gob, int geb) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* r = read + (size_t)b * R;
  const int nj = min(glen[b], G);
  const int ni = min(rlen[b], R);
  int h[GMAX];   // H of the previous row, columns 0..nj-1
  int f[GMAX];   // F (vertical gap) of the previous row
  for (int j = 0; j < nj; ++j) {
    h[j] = 0;
    f[j] = NEG;
  }
  int best = 0;
  for (int i = 0; i < ni; ++i) {
    const int rch = r[i];
    // colour space: row 0 compares against g_row0 (one select per row)
    const uint8_t* gi = (i == 0 && g_row0 != nullptr)
                            ? g_row0 + (size_t)b * G : g;
    int hdiag = 0;   // H[i-1][j-1]; the j = -1 pad column is always 0
    int c = FILL;    // running max of h0[k] + k*gea over k < j
    for (int j = 0; j < nj; ++j) {
      const int hp = h[j];
      const int fj = max(hp - gob, f[j] - geb);
      const int s = (gi[j] == rch) ? m : mm;
      const int h0 = max(max(0, hdiag + s), fj);
      const int e = c - (goa - gea) - j * gea;
      const int hj = max(h0, e);
      c = max(c, h0 + j * gea);
      best = max(best, hj);
      hdiag = hp;
      h[j] = hj;
      f[j] = fj;
    }
  }
  out[b] = best;
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
inline int wide_smem(int G) { return 2 * G * 4 + ((G + 15) & ~15); }

__global__ void __launch_bounds__(32)
sw_vector_wide_kernel(const uint8_t* __restrict__ genome,
                      const uint8_t* __restrict__ g_row0,
                      const int32_t* __restrict__ glen,
                      const uint8_t* __restrict__ read,
                      const int32_t* __restrict__ rlen,
                      int32_t* __restrict__ out, int G, int R, int m,
                      int mm, int goa, int gea, int gob, int geb) {
  extern __shared__ int4 smem[];
  int* h = reinterpret_cast<int*>(smem);   // H of the previous row
  int* f = h + G;                          // F of the previous row
  uint8_t* gsh = reinterpret_cast<uint8_t*>(f + G);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nj = min(glen[b], G);
  const int ni = min(rlen[b], R);
  for (int j = lane; j < nj; j += 32) {
    h[j] = 0;
    f[j] = NEG;
    gsh[j] = genome[(size_t)b * G + j];
  }
  __syncwarp();
  const int S = ((nj + 31) / 32) | 1;
  const int j0 = min(lane * S, nj), j1 = min(j0 + S, nj);
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

template <int GMAX>
void launch(const void* genome, const void* g_row0, const void* glen,
            const void* read, const void* rlen, void* out, int B, int G,
            int R, int m, int mm, int goa, int gea, int gob, int geb,
            cudaStream_t stream) {
  sw_vector_kernel<GMAX><<<(B + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      static_cast<const uint8_t*>(genome),
      static_cast<const uint8_t*>(g_row0), static_cast<const int32_t*>(glen),
      static_cast<const uint8_t*>(read), static_cast<const int32_t*>(rlen),
      static_cast<int32_t*>(out), B, G, R, m, mm, goa, gea, gob, geb);
}

}  // namespace

// genome [B, G] u8, g_row0 [B, G] u8 or null (letter space), glen [B]
// i32, read [B, R] u8, rlen [B] i32 -> out [B] i32. goa/gob are open +
// extend costs and gea/geb extend costs, all as positive penalties.
// G <= 256 takes the thread-per-pair kernel, 256 < G <= 4095 the
// warp-per-pair kernel. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for G > 4095).
extern "C" int sw_vector_launch(const void* genome, const void* g_row0,
                                const void* glen, const void* read,
                                const void* rlen, void* out, int B, int G,
                                int R, int m, int mm, int goa, int gea,
                                int gob, int geb, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 64)
    launch<64>(genome, g_row0, glen, read, rlen, out, B, G, R, m, mm, goa,
               gea, gob, geb, st);
  else if (G <= 128)
    launch<128>(genome, g_row0, glen, read, rlen, out, B, G, R, m, mm, goa,
                gea, gob, geb, st);
  else if (G <= 256)
    launch<256>(genome, g_row0, glen, read, rlen, out, B, G, R, m, mm, goa,
                gea, gob, geb, st);
  else if (G <= 4095)
    sw_vector_wide_kernel<<<B, 32, wide_smem(G), st>>>(
        static_cast<const uint8_t*>(genome),
        static_cast<const uint8_t*>(g_row0),
        static_cast<const int32_t*>(glen), static_cast<const uint8_t*>(read),
        static_cast<const int32_t*>(rlen), static_cast<int32_t*>(out), G, R,
        m, mm, goa, gea, gob, geb);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
