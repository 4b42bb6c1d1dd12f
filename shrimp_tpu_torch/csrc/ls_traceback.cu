// Letter-space traceback of the full-SW backpointers, hand-written for
// Hopper (sm_90a).
//
// Replaces: shrimp_tpu/core/sw_jax.py::_traceback_pack, device code of
// the traceback flow (a jax.lax.while_loop, not Pallas), which walks the
// backpointers of sw_full_pallas' emit_bp=True kernel (do_backtrace,
// sw-full-ls.c:413-516) from each pair's best cell and packs, bit-equal
// to it: [B, 10] int32 = score, max_i, max_j, nops, rs, gs, matches,
// mismatches, ins, dels, and the 2-bit ops in walk order, four to a
// byte, [B, (R+G+3)/4] uint8. As in the reference, a pair starts its
// walk from (max_i, max_j) in its start plane even when its score is 0,
// the walk stops after R + G steps or at a from-code 0, the window and
// read indexes of the match test are clamped, and rs / gs are 0 when the
// walk consumed no read / genome position.
//
// What bounds it on an H100: the latency of one walk. Each step's cell
// depends on the previous step's from-code, so a walk is a chain of up
// to R + G dependent loads and decodes, and a launch lasts as long as
// its longest walk (about 350 steps at the 250 bp launch, 1100 at
// 1000 bp) plus the time the card needs to issue every walk's steps.
// The backpointers [B, R, G] are 369 MB at the 250 bp launch, seven
// times the L2: a cell read from device memory costs a round trip.
//
// What the design does about it:
// - A warp per (window, read) pair, PAIRS pairs a block when the launch
//   has enough pairs to give every SM a block (one otherwise, so that
//   small launches spread over more SMs). The warp stages the window
//   and the read in shared memory once.
// - The walk is fed from shared memory: the warp copies a tile of TH
//   rows x TW columns of backpointers whose bottom-right corner holds the
//   walk's cell (cp.async in 16-byte pieces, so G must be a multiple of
//   16 and the backpointers 16-byte aligned; the launch refuses other
//   inputs), and lane 0 walks inside it until the walk stops or leaves
//   through the tile's top or left side.
// - While lane 0 walks, the warp prefetches into a second buffer the
//   tile that a walk leaving along its diagonal through the top enters;
//   a walk that leaves elsewhere reloads at its new cell.
// - A step is one decode and a branch per exit (op 0, the step cap, the
//   tile's edge): the step tables are registers, and the three cells the
//   walk can move to are loaded while the current one decodes (guard
//   bytes above and left of the tile keep those loads inside the
//   buffer). A loop with a single exit test a step was 1-2 % slower on
//   the long-read flow's own launches and 2-4 % on chip_smoke's 250 bp
//   test pairs, 16-18 % faster at 1000 bp (PERF.md, kernel_ab.py).
// - The ops collect 16 to a word in shared memory and leave whole, zero
//   tail included; the insertion, deletion and match/mismatch counts are
//   popcounts over the ops words, summed over the warp, and lane 0
//   counts only the matches.
// - Any G: a pair's shared memory is the two tiles (5 KB) plus about
//   1.25 (R + G) bytes, which fits a block to about R + G = 180,000. Past
//   that the kernel's GLOBAL instance stages the tiles alone: the walk
//   reads the window and the read where they lie and collects its ops
//   words in a device-memory scratch that the caller allocates.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int PAIRS = 4;   // warps, one pair each, per block (large B)
// tile rows and columns: the fastest of 32 x 48, 32 x 64, 32 x 96 and
// 64 x 96 on the card
constexpr int TH = 32;     // a multiple of 32
constexpr int TW = 64;     // a multiple of 16
static_assert(TH % 32 == 0 && TW % 16 == 0, "tile shape");
// a tile buffer: a guard row above the tile and 16 guard bytes left of
// each row, so that the walk's look-ahead loads stay inside the buffer
constexpr int TS = TW + 16;            // row stride
constexpr int TILE = (TH + 1) * TS;    // bytes, a multiple of 16
constexpr unsigned FULL_MASK = 0xffffffffu;
// emitted ops (sw_jax BACK_*); 0 ends the walk
constexpr int BACK_INS = 1, BACK_DEL = 2, BACK_MM = 3;

// The walk's step tables, one per plane (0 nw, 1 n, 2 w). A cell's
// backpointer byte holds nw | n << 2 | w << 4; plane q reads the field
// f = (byte >> 2q) & 3, and nibble f of its table is op | next_q << 2
// (the reference's FROM_* codes, sw-full-ls.c:36-42: NW plane 1 NWNW,
// 2 NWN, 3 NWW; N plane 1 NN, 2 NNW; W plane 1 WW, 2 WNW; other fields
// 0).
constexpr unsigned lut_entry(int f, int op, int next) {
  return static_cast<unsigned>(op | next << 2) << (4 * f);
}
constexpr unsigned LUT_NW = lut_entry(1, BACK_MM, 0) | lut_entry(2, BACK_MM, 1)
                            | lut_entry(3, BACK_MM, 2);
constexpr unsigned LUT_N = lut_entry(1, BACK_DEL, 1) | lut_entry(2, BACK_DEL, 0);
constexpr unsigned LUT_W = lut_entry(1, BACK_INS, 2) | lut_entry(2, BACK_INS, 0);

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// 32-bit words of ops of a walk of at most R + G steps (16 ops a word)
__host__ __device__ inline int op_words(int G, int R) {
  return (R + G + 15) / 16;
}
// bytes of shared memory of one pair: two tile buffers, the genome
// window, the read and the ops (the tiles alone in the GLOBAL instance)
__host__ __device__ inline long long pair_bytes(int G, int R) {
  return 2 * TILE + (long long)pad16(G) + pad16(R)
         + pad16(4 * op_words(G, R));
}

// 16-byte copy from device to shared memory that does not pass through
// registers (cp.async); cp_async_wait waits for every copy this thread
// issued
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
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// the tile of the walk's cell (ci, cj): rows [top, ci], columns
// [left, left + min(TW, G - left)), the cell in the last 16 columns
__device__ __forceinline__ int tile_top(int ci) { return max(ci - (TH - 1), 0); }
__device__ __forceinline__ int tile_left(int cj) {
  return max(((cj + 16) & ~15) - TW, 0);
}

// The warp copies rows [top, ci] and columns [left, left + nc) of the
// pair's backpointers into a tile buffer, a row per lane at a time, in
// 16-byte cp.async pieces (G and left are multiples of 16).
__device__ __forceinline__ void load_tile(uint8_t* buf,
                                          const uint8_t* __restrict__ bpb,
                                          int G, int top, int ci, int left,
                                          int lane) {
  int rows = ci - top + 1, nc = min(TW, G - left);
  // keep the loop bounds opaque to the optimizer: a guard against the
  // ptxas fold of banded_sw.cuh, which costs nothing here; a
  // clock-instrumented copy of this kernel faulted without it (PERF.md
  // section 7)
  asm volatile("" : "+r"(rows), "+r"(nc));
  for (int tr = lane; tr < rows; tr += 32) {
    const uint8_t* src = bpb + (size_t)(top + tr) * G + left;
    uint8_t* dst = buf + (tr + 1) * TS + 16;
    for (int k = 0; k < nc; k += 16) cp_async16(dst + k, src + k);
  }
}

template <bool GLOBAL>
__global__ void __launch_bounds__(32 * PAIRS)
ls_traceback_kernel(const uint8_t* __restrict__ genome,
                    const uint8_t* __restrict__ read,
                    const int32_t* __restrict__ score,
                    const int32_t* __restrict__ max_i,
                    const int32_t* __restrict__ max_j,
                    const int32_t* __restrict__ plane,
                    const uint8_t* __restrict__ bp,
                    int32_t* __restrict__ packed, uint8_t* __restrict__ ops,
                    uint32_t* __restrict__ scratch, int B, int G, int R) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem)
                  + warp * (GLOBAL ? 2 * TILE : pair_bytes(G, R));
  // the genome window, the read and the ops words: staged in shared
  // memory, or (GLOBAL) the inputs where they lie and the pair's scratch
  uint8_t* gst = base + 2 * TILE;
  uint8_t* rst = gst + pad16(G);
  const uint8_t* gsh = GLOBAL ? genome + (size_t)b * G : gst;
  const uint8_t* rsh = GLOBAL ? read + (size_t)b * R : rst;
  uint32_t* opw = GLOBAL ? scratch + (size_t)b * op_words(G, R)
                         : reinterpret_cast<uint32_t*>(rst + pad16(R));
  const uint8_t* bpb = bp + (size_t)b * R * G;
  const int L = R + G;

  // the start cell, read clamped (the DP gives 0 <= max_i < R and
  // 0 <= max_j < G; a negative start reads row or column 0 and stops
  // after one step, as in the reference)
  const int i0 = max_i[b], j0 = max_j[b];
  int ci = min(max(i0, 0), R - 1), cj = min(max(j0, 0), G - 1);
  int top = tile_top(ci), left = tile_left(cj), cur = 0;
  load_tile(base, bpb, G, top, ci, left, lane);
  if (!GLOBAL) {
    for (int k = lane; k < G; k += 32) gst[k] = genome[(size_t)b * G + k];
    for (int k = lane; k < R; k += 32) rst[k] = read[(size_t)b * R + k];
  }
  for (int k = lane; k < op_words(G, R); k += 32) opw[k] = 0;
  cp_async_wait();
  __syncwarp();

  // lane 0's walk state: the plane's field shift and step table, the
  // step count and cap, the match count and the ops word being filled
  const int pl = plane[b];   // 0 nw, 1 w, 2 n
  int q2 = pl == 0 ? 0 : pl == 1 ? 4 : 2;
  unsigned lut = pl == 0 ? LUT_NW : pl == 1 ? LUT_W : LUT_N;
  const int lim = (i0 < 0 || j0 < 0) ? 1 : L;
  int t = 0, n_match = 0, sh = 0;
  uint32_t acc = 0;
  bool done = false;
  for (;;) {
    // prefetch the tile that a walk leaving this one along its diagonal
    // through the top enters, into the other buffer
    const int pi = top - 1, pj = cj - (ci - top) - 1;
    const bool pre = pi >= 0 && pj >= 0;
    const int ptop = tile_top(max(pi, 0)), pleft = tile_left(max(pj, 0));
    if (pre) load_tile(base + (cur ^ 1) * TILE, bpb, G, ptop, pi, pleft, lane);
    if (lane == 0) {
      const uint8_t* tl = base + cur * TILE;
      const uint8_t* gp = gsh + left;
      const uint8_t* rp = rsh + top;
      int rr = ci - top, cc = cj - left;   // the cell in the tile
      int p = (rr + 1) * TS + 16 + cc;
      int v = tl[p];
      for (;;) {
        // the three cells the walk can move to, loaded while this one
        // decodes; a branch per exit (op 0, the step cap, the tile's
        // edge)
        const int vn = tl[p - TS], vw = tl[p - 1], vd = tl[p - TS - 1];
        const int e = static_cast<int>((lut >> (4 * ((v >> q2) & 3))) & 15);
        const int op = e & 3;
        if (op == 0) {
          done = true;
          break;
        }
        if (op == BACK_MM) n_match += gp[cc] == rp[rr];
        acc |= static_cast<uint32_t>(op) << sh;
        sh += 2;
        if (sh == 32) {   // the word is full
          opw[t >> 4] = acc;
          acc = 0;
          sh = 0;
        }
        ++t;
        const int nq = e >> 2;
        q2 = 2 * nq;
        lut = nq == 0 ? LUT_NW : nq == 1 ? LUT_N : LUT_W;
        const int di = op >> 1, dj = op & 1;   // DEL, MM up; INS, MM left
        rr -= di;
        cc -= dj;
        if (t >= lim) {
          done = true;
          break;
        }
        if ((rr | cc) < 0) break;   // left the tile through its top or left
        v = op == BACK_MM ? vd : op == BACK_DEL ? vn : vw;
        p -= di * TS + dj;
      }
      ci = top + rr;
      cj = left + cc;
      done = done || ci < 0 || cj < 0;
    }
    done = __shfl_sync(FULL_MASK, done, 0);
    ci = __shfl_sync(FULL_MASK, ci, 0);
    cj = __shfl_sync(FULL_MASK, cj, 0);
    cp_async_wait();   // the prefetch has landed
    __syncwarp();
    if (done) break;
    if (pre && ci == pi && cj >= pleft && cj < pleft + TW) {
      cur ^= 1;        // the walk is inside the prefetched tile
      top = ptop;
      left = pleft;
    } else {           // reload the walked buffer at the new cell
      top = tile_top(ci);
      left = tile_left(cj);
      load_tile(base + cur * TILE, bpb, G, top, ci, left, lane);
      cp_async_wait();
      __syncwarp();
    }
  }
  if (lane == 0 && sh) opw[t >> 4] = acc;
  __syncwarp();

  // the tallies of the ops (fields 1 INS, 2 DEL, 3 MM), over the warp
  int n_ins = 0, n_del = 0, n_mm = 0;
  for (int k = lane; k < op_words(G, R); k += 32) {
    const uint32_t x = opw[k], hi = x >> 1;
    n_ins += __popc(x & ~hi & 0x55555555u);
    n_del += __popc(hi & ~x & 0x55555555u);
    n_mm += __popc(x & hi & 0x55555555u);
  }
  n_ins = __reduce_add_sync(FULL_MASK, n_ins);
  n_del = __reduce_add_sync(FULL_MASK, n_del);
  n_mm = __reduce_add_sync(FULL_MASK, n_mm);
  // the ops, four to a byte in walk order, zero after the walk's end
  const int W = (L + 3) / 4;
  const uint8_t* ob = reinterpret_cast<const uint8_t*>(opw);
  uint8_t* o = ops + (size_t)b * W;
  for (int k = lane; k < W; k += 32) o[k] = ob[k];
  if (lane == 0) {
    const int cr = n_del + n_mm, cg = n_ins + n_mm;
    int32_t* pk = packed + (size_t)b * 10;
    pk[0] = score[b];
    pk[1] = i0;
    pk[2] = j0;
    pk[3] = t;
    pk[4] = cr > 0 ? i0 - cr + 1 : 0;
    pk[5] = cg > 0 ? j0 - cg + 1 : 0;
    pk[6] = n_match;
    pk[7] = n_mm - n_match;
    pk[8] = n_ins;
    pk[9] = n_del;
  }
}

// Pairs per block for a launch of B pairs: PAIRS when every SM still gets
// a block and PAIRS pairs' shared memory fits a block, else fewer. Sets
// the kernel's dynamic shared memory limit when above 48 KB. `global`:
// one pair's window, read and ops do not fit a block (the GLOBAL
// instance, the tiles alone in shared memory).
cudaError_t prepare(int B, int G, int R, int* pairs, int* smem,
                    bool* global) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *global = pair_bytes(G, R) > optin;
  const long long pb = *global ? 2 * TILE : pair_bytes(G, R);
  int p = B / PAIRS >= sms ? PAIRS : 1;
  while (p > 1 && p * pb > optin) --p;
  *pairs = p;
  *smem = static_cast<int>(p * pb);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*global ? ls_traceback_kernel<true>
                                      : ls_traceback_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, score/max_i/max_j/plane [B] i32,
// bp [B, R, G] u8 -> packed [B, 10] i32, ops [B, (R+G+3)/4] u8. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when G is
// not a multiple of 16 or bp is not 16-byte aligned: the tiles load in
// 16-byte pieces) or, where the launch needs one (ls_traceback_scratch),
// for a null scratch.
extern "C" int ls_traceback_launch(const void* genome, const void* read,
                                   const void* score, const void* max_i,
                                   const void* max_j, const void* plane,
                                   const void* bp, void* packed, void* ops,
                                   int B, int G, int R, void* stream,
                                   void* scratch) {
  if (B <= 0) return 0;
  if (G < 1 || R < 1 || (G & 15) != 0
      || (reinterpret_cast<uintptr_t>(bp) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int pairs = 1, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (global && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = global ? ls_traceback_kernel<true>
                       : ls_traceback_kernel<false>;
  kernel<<<(B + pairs - 1) / pairs, 32 * pairs, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), static_cast<const uint8_t*>(read),
      i32(score), i32(max_i), i32(max_j), i32(plane),
      static_cast<const uint8_t*>(bp), static_cast<int32_t*>(packed),
      static_cast<uint8_t*>(ops), static_cast<uint32_t*>(scratch), B, G,
      R);
  return static_cast<int>(cudaGetLastError());
}

// The device memory, in bytes, that a launch of B pairs of G columns and
// R rows needs beside its outputs, into *(long long*)out: the pairs' ops
// words where one pair's window, read and ops do not fit a block's
// shared memory, else 0. Returns a cudaError_t.
extern "C" int ls_traceback_scratch(int B, int G, int R, void* out) {
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (B <= 0 || G < 1 || R < 1) return 0;
  int pairs = 1, smem = 0;
  bool global = false;
  const cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (global) *o = 4LL * op_words(G, R) * B;
  return static_cast<int>(e);
}

// The launch configuration of B pairs of G columns and R rows: out[0..5]
// = pairs per block, threads per pair, dynamic shared memory bytes per
// block, resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers per thread and local (spill) bytes per thread. Returns a
// cudaError_t.
extern "C" int ls_traceback_config(int B, int G, int R, void* out) {
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  int pairs = 1, smem = 0;
  bool global = false;
  cudaError_t e = prepare(B, G, R, &pairs, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = global ? ls_traceback_kernel<true>
                       : ls_traceback_kernel<false>;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    32 * pairs, smem);
  o[0] = pairs;
  o[1] = 32;
  o[2] = smem;
  o[3] = blocks;
  o[4] = fa.numRegs;
  o[5] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(e);
}
