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
// What bounds it on an H100: the latency of a pair's rows. The rows of a
// pair run in order, and each is a chain of dependent steps: the band,
// shared-memory loads of the previous row, the W chain's scan across the
// pair's lanes, two passes over the strip, the warp syncs. The work is
// small: about forty int32 operations per in-band cell, a quarter of the
// R x G cells of a 36 bp launch (G = 64) and less of the wider buckets,
// and device memory supplies only the window and read bytes.
//
// What the design does about it: the DP of banded_sw.cuh, band-only
// work on a segment of L lanes per (window, read) pair, L chosen per G
// bucket (LANES_NARROW and LANES_WIDE below, the fastest of 4, 8, 16
// and 32 on the card), 128 threads a block. The previous row lives in
// shared memory, one int4 per column: nw, n, w and the diagonal chain
// packed as run | (deq - base) << 12 | term << 24. deq itself runs
// along the whole diagonal, band or not (deq(i, j) counts the
// window/read matches on the diagonal from its start to (i, j)), so only
// deq - base is carried: it is 0 outside the band and grows by the match
// bit along a chain; deq is counted once, at the best cell, by the
// segment after the last row. The revcmpl flag is a per-pair register,
// not a template parameter, so that the segments of one warp run the same
// code. Rows at or past rlen are never recorded, so each segment stops at
// its own rlen, with segment masks on its syncs and shuffles.
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

using banded::Cell;
using banded::NEG;
using banded::pad16;

constexpr int THREADS = 128;   // threads per block (large B)
// lanes per pair: G <= 128 (reads up to about 90 bp: the windows are
// about 140 % of the read), and 128 < G <= 256
constexpr int LANES_NARROW = 8;
constexpr int LANES_WIDE = 32;
// the chain word: run (bits 0-11), deq - base (12-23), term (24-25);
// run and deq - base are at most G <= 256
constexpr int CH_BD = 12, CH_TERM = 24, CH_MASK = 0xfff;

// A pair's shared memory: the planes and chain of each column, the
// genome window, the read and the best cell's record.
struct StatsPlanes {
  int4* P;   // nw, n, w, chain of column j
  uint8_t* gsh;
  uint8_t* rsh;
  int* pk;   // the best cell: i, j, nw, n, w, chain

  __host__ __device__ static int bytes(int G, int R) {
    return 16 * G + pad16(G) + pad16(R) + 32;
  }
  __device__ StatsPlanes(uint8_t* base, int G, int R)
      : P(reinterpret_cast<int4*>(base)),
        gsh(base + 16 * G),
        rsh(gsh + pad16(G)),
        pk(reinterpret_cast<int*>(rsh + pad16(R))) {}

  __device__ __forceinline__ Cell load(int j) const {
    const int4 t = P[j];
    return {t.x, t.y, t.z, t.w};
  }
  __device__ __forceinline__ void reset(int j, int nw, int n, int w) {
    P[j] = make_int4(nw, n, w, 0);
  }
  // a NW-from-NW cell extends the diagonal's chain (run + 1, deq - base
  // + eq, term kept); any other starts one (term = its from-code). The
  // previous row's w stays until pass 2.
  __device__ __forceinline__ void put1(int j, const Cell& u, const Cell& d,
                                       int nw, int n, int nw_from, int,
                                       int eq) {
    const int ch = nw_from == banded::NW_FROM_NW
                       ? d.x + 1 + (eq << CH_BD)
                       : nw_from << CH_TERM;
    P[j] = make_int4(nw, n, u.w, ch);
  }
  __device__ __forceinline__ int2 nn(int j) const {
    return *reinterpret_cast<const int2*>(&P[j]);
  }
  __device__ __forceinline__ void put2(int j, int w, int) { P[j].z = w; }
  __device__ __forceinline__ void pick(int i, int j) {
    const int4 t = P[j];
    pk[0] = i;
    pk[1] = j;
    pk[2] = max(t.x, NEG);
    pk[3] = max(t.y, NEG);
    pk[4] = max(t.z, NEG);
    pk[5] = t.w;
  }
  __device__ __forceinline__ void end_row(int, int) {}
};

template <int L, bool LOCAL>
__global__ void __launch_bounds__(THREADS)
sw_full_stats_kernel(const uint8_t* __restrict__ genome,
                     const int32_t* __restrict__ glen,
                     const uint8_t* __restrict__ read,
                     const int32_t* __restrict__ rlen,
                     const int32_t* __restrict__ ax,
                     const int32_t* __restrict__ ay,
                     const int32_t* __restrict__ alen,
                     const int32_t* __restrict__ awid,
                     const int32_t* __restrict__ rev,
                     int32_t* __restrict__ out, int B, int G, int R, int m,
                     int mm, int goa, int gea, int gob, int geb) {
  extern __shared__ int4 smem[];
  const int seg = threadIdx.x / L, sl = threadIdx.x % L;
  const int b = blockIdx.x * (blockDim.x / L) + seg;
  if (b >= B) return;
  // this segment's lanes of the warp
  const unsigned mask =
      L == 32 ? 0xffffffffu
              : ((1u << L) - 1) << ((threadIdx.x & 31) / L * L);
  StatsPlanes P(reinterpret_cast<uint8_t*>(smem)
                    + seg * StatsPlanes::bytes(G, R),
                G, R);
  if (sl == 0) {
    P.pk[0] = P.pk[1] = 0;
    P.pk[2] = P.pk[3] = P.pk[4] = NEG;
    P.pk[5] = 0;
  }
  const banded::Pair p = {glen[b], rlen[b], ax[b], ay[b], alen[b], awid[b]};
  const int best = banded::dp<L, LOCAL>(
      P, sl, mask, genome + (size_t)b * G, read + (size_t)b * R,
      min(p.rl, R), p, rev[b] != 0, G, R, {m, mm, goa, gea, gob, geb});
  __syncwarp(mask);

  // deq at the best cell: the matches on its diagonal from the diagonal's
  // start (row 0 or column 0) down to the cell
  const int bi = P.pk[0], bj = P.pk[1];
  const bool upd = best > NEG;   // some row recorded a cell
  int deq = 0;
  if (upd)
    for (int k = sl; k <= min(bi, bj); k += L)
      deq += P.gsh[bj - k] == P.rsh[bi - k];
#pragma unroll
  for (int d = L / 2; d > 0; d >>= 1)
    deq += __shfl_xor_sync(mask, deq, d, L);

  if (sl == 0) {
    const int ch = P.pk[5];
    const bool has = best > 0;
    const int plane = banded::best_plane(P.pk[2], P.pk[3], P.pk[4]);
    int4* o = reinterpret_cast<int4*>(out + (size_t)b * 8);
    o[0] = make_int4(max(best, 0), has ? bi : 0, has ? bj : 0,
                     has ? plane : 0);
    o[1] = upd ? make_int4(ch & CH_MASK, (ch >> CH_TERM) & 3, deq,
                           deq - ((ch >> CH_BD) & CH_MASK))
               : make_int4(NEG, NEG, NEG, NEG);
  }
}

template <int L>
cudaError_t prepare(int B, int G, int R, int* threads, int* smem) {
  const decltype(&sw_full_stats_kernel<L, false>) ks[] = {
      sw_full_stats_kernel<L, false>, sw_full_stats_kernel<L, true>};
  return banded::prepare(ks, B, L, THREADS, StatsPlanes::bytes(G, R),
                         threads, smem);
}

template <int L>
int launch(const void* genome, const void* glen, const void* read,
           const void* rlen, const void* ax, const void* ay, const void* alen,
           const void* awid, const void* rev, void* out, int B, int G, int R,
           int m, int mm, int goa, int gea, int gob, int geb, int local,
           cudaStream_t stream) {
  int threads = THREADS, smem = 0;
  const cudaError_t e = prepare<L>(B, G, R, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = threads / L;
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = local ? sw_full_stats_kernel<L, true>
                      : sw_full_stats_kernel<L, false>;
  kernel<<<(B + pairs - 1) / pairs, threads, smem, stream>>>(
      static_cast<const uint8_t*>(genome), i32(glen),
      static_cast<const uint8_t*>(read), i32(rlen), i32(ax), i32(ay),
      i32(alen), i32(awid), i32(rev), static_cast<int32_t*>(out), B, G, R,
      m, mm, goa, gea, gob, geb);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int config(int B, int G, int R, int* o) {
  int threads = THREADS, smem = 0;
  const cudaError_t e = prepare<L>(B, G, R, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return banded::config(sw_full_stats_kernel<L, false>, L, threads, smem, o);
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, glen/rlen/ax/ay/alen/awid/rev [B]
// i32 -> out [B, 8] i32. goa/gea/gob/geb are the open and extend costs
// as positive penalties (open NOT including extend, as in
// sw_full_pallas). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for G outside [1, 256]).
extern "C" int sw_full_stats_launch(const void* genome, const void* glen,
                                    const void* read, const void* rlen,
                                    const void* ax, const void* ay,
                                    const void* alen, const void* awid,
                                    const void* rev, void* out, int B, int G,
                                    int R, int m, int mm, int goa, int gea,
                                    int gob, int geb, int local,
                                    void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > 256 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 128)
    return launch<LANES_NARROW>(genome, glen, read, rlen, ax, ay, alen, awid,
                                rev, out, B, G, R, m, mm, goa, gea, gob, geb,
                                local, st);
  return launch<LANES_WIDE>(genome, glen, read, rlen, ax, ay, alen, awid,
                            rev, out, B, G, R, m, mm, goa, gea, gob, geb,
                            local, st);
}

// The launch configuration of B pairs of G columns and R rows (of the
// global-mode kernel, the main path's): banded::config's six values.
// Returns a cudaError_t.
extern "C" int sw_full_stats_config(int B, int G, int R, void* out) {
  if (G < 1 || G > 256 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  if (G <= 128) return config<LANES_NARROW>(B, G, R, o);
  return config<LANES_WIDE>(B, G, R, o);
}
