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
// What bounds it on an H100: latency. Each step is one dependent 2-byte
// load from the backpointer tensor (tens of MB, mostly in L2) plus a
// dozen integer operations, and a walk is at most R + G steps.
//
// What the simple design does about it: one thread per pair, so a
// launch walks every pair's path at once (its plain version is R + G
// sequential steps of about 20 small tensor operations each). Blocks are
// one warp, to spread a 2048-pair launch over 64 SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 32;
constexpr int BASE_N = 15;
constexpr int NN = 1, NNW = 2, WNW = 3, WW = 4, NWN = 5;
// the plane (0 nw, 1 n, 2 w) a direction-pair code continues in
__constant__ int NEXT_PLANE[8] = {0, 1, 0, 0, 2, 1, 0, 2};

__global__ void __launch_bounds__(BLOCK)
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
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* q = qr + (size_t)b * 4 * R;
  const int W = R + G;
  int8_t* out = steps + (size_t)b * W;
  const int best = best_[b];
  const int score = best >= thresh_[b] ? best : 0;
  const int bi = bi_[b], bj = bj_[b], bk = bk_[b];
  int i = bi, j = bj, k = bk, frm = bfrm_[b];
  int rs = 0, gs = 0, nm = 0, nmm = 0, ins = 0, del = 0, xo = 0, nops = 0;
  bool act = frm != 0 && score > 0;
  // the walk is a prefix of the W steps; the rest are 0
  for (int t = 0; t < W && act; ++t) {
    const int code = frm >> 2, lyr = frm & 3;
    const bool is_n = code == NN || code == NNW;
    const bool is_w = code == WNW || code == WW;
    const bool is_nw = code >= NWN;
    del += is_n;
    ins += is_w;
    const int gch = g[min(max(j, 0), G - 1)];
    const int rch = q[min(max(k, 0), 3) * R + min(max(i, 0), R - 1)];
    const bool okm = gch == rch || gch == BASE_N || rch == BASE_N;
    nm += is_nw && okm;
    nmm += is_nw && !okm;
    if (is_n || is_nw) rs = i;
    if (is_w || is_nw) gs = j;
    const int op = is_n ? 2 : (is_w ? 1 : (is_nw ? 3 : 0));
    const bool xov = lyr != k;
    xo += xov;
    out[t] = (int8_t)(op | k << 2 | (xov ? 16 : 0));
    k = lyr;
    ++nops;
    i -= is_n || is_nw;
    j -= is_w || is_nw;
    if (i < 0 || j < 0) break;
    const int nxt = NEXT_PLANE[min(max(code, 0), 7)];
    const int v = bp[(((size_t)b * R + min(i, R - 1)) * 4 + k) * G
                     + min(j, G - 1)];
    frm = (v >> (5 * nxt)) & 31;
    act = frm != 0;
  }
  for (int s = nops; s < W; ++s) out[s] = 0;
  // leading crossover when the alignment starts in a layer other than 0
  if (score > 0 && k != 0 && nops > 0) {
    out[nops - 1] |= 16;
    ++xo;
  }
  int16_t* p = packed + (size_t)b * 12;
  const int vals[12] = {score, bi, bj, bk, nops, rs, gs, nm, nmm, ins, del,
                        xo};
#pragma unroll
  for (int c = 0; c < 12; ++c) p[c] = (int16_t)vals[c];
}

}  // namespace

// genome [B, G] u8 (letters), qr [B, 4, R] u8, best/bi/bj/bk/bfrm/thresh
// [B] i32, bp [B, R, 4, G] i16 -> packed [B, 12] i16, steps
// [B, R + G] i8. Returns cudaGetLastError() after the launch.
extern "C" int cs_traceback_launch(const void* genome, const void* qr,
                                   const void* best, const void* bi,
                                   const void* bj, const void* bk,
                                   const void* bfrm, const void* bp,
                                   const void* thresh, void* packed,
                                   void* steps, int B, int G, int R,
                                   void* stream) {
  if (B <= 0) return 0;
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  cs_traceback_kernel<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), static_cast<const uint8_t*>(qr),
      i32(best), i32(bi), i32(bj), i32(bk), i32(bfrm),
      static_cast<const int16_t*>(bp), i32(thresh),
      static_cast<int16_t*>(packed), static_cast<int8_t*>(steps), B, G, R);
  return static_cast<int>(cudaGetLastError());
}
