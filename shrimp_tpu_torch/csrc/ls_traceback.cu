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
// and rs / gs are 0 when the walk consumed no read / genome position.
//
// What bounds it on an H100: latency. A walk is a chain of dependent
// one-byte loads (each step's cell depends on the previous step's
// from-code), up to R + G steps, while the bytes touched are a few per
// step; the plain version pays one round of small launches per step.
//
// What the simple design does about it: one thread per pair walks its
// own chain to the end, counting positions, matches and mismatches on
// the fly, and writes its ops as it goes; many pairs in flight hide the
// load latency. The backpointers were just written by sw_full_bp, so
// the walks find most of them still in L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;
// reference FROM_* codes (sw-full-ls.c:36-42)
constexpr int F_NN = 1, F_NNW = 2, F_WNW = 3, F_WW = 4, F_NWN = 5,
              F_NWNW = 6, F_NWW = 7;
// emitted ops (sw_jax BACK_*)
constexpr int BACK_INS = 1, BACK_DEL = 2, BACK_MM = 3;

// the FROM code of a cell's backpointer byte in plane 0 (nw), 1 (w) or
// 2 (n)
__device__ __forceinline__ int decode(int v, int plane) {
  if (plane == 0) {
    const int f = v & 3;
    return f == 1 ? F_NWNW : f == 2 ? F_NWN : f == 3 ? F_NWW : 0;
  }
  if (plane == 1) {
    const int f = (v >> 4) & 3;
    return f == 1 ? F_WW : f == 2 ? F_WNW : 0;
  }
  const int f = (v >> 2) & 3;
  return f == 1 ? F_NN : f == 2 ? F_NNW : 0;
}

// the plane a FROM code continues in (0 nw, 1 w, 2 n)
__device__ __forceinline__ int next_plane(int frm) {
  return (frm == F_NN || frm == F_NWN) ? 2
         : (frm == F_WW || frm == F_NWW) ? 1 : 0;
}

__global__ void __launch_bounds__(BLOCK)
ls_traceback_kernel(const uint8_t* __restrict__ genome,
                    const uint8_t* __restrict__ read,
                    const int32_t* __restrict__ score,
                    const int32_t* __restrict__ max_i,
                    const int32_t* __restrict__ max_j,
                    const int32_t* __restrict__ plane,
                    const uint8_t* __restrict__ bp,
                    int32_t* __restrict__ packed, uint8_t* __restrict__ ops,
                    int B, int G, int R) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  const uint8_t* g = genome + (size_t)b * G;
  const uint8_t* r = read + (size_t)b * R;
  const uint8_t* bpb = bp + (size_t)b * R * G;
  const int L = R + G;
  const int W = (L + 3) / 4;
  uint8_t* o = ops + (size_t)b * W;
  const int i0 = max_i[b], j0 = max_j[b];
  int i = i0, j = j0;
  int frm = decode(bpb[(size_t)min(max(i0, 0), R - 1) * G
                       + min(max(j0, 0), G - 1)], plane[b]);
  int t = 0, nops = 0, n_match = 0, n_mis = 0, n_ins = 0, n_del = 0;
  int cr = 0, cg = 0;
  unsigned acc = 0;
  while (t < L && frm != 0) {
    const bool is_n = frm == F_NN || frm == F_NNW;
    const bool is_w = frm == F_WNW || frm == F_WW;
    const bool is_nw = frm >= F_NWN;
    const int op = is_n ? BACK_DEL : is_w ? BACK_INS : BACK_MM;
    if (is_nw) {
      if (g[min(max(j, 0), G - 1)] == r[min(max(i, 0), R - 1)])
        ++n_match;
      else
        ++n_mis;
    }
    n_ins += is_w;
    n_del += is_n;
    cr += is_n || is_nw;
    cg += is_w || is_nw;
    ++nops;
    acc |= static_cast<unsigned>(op) << (2 * (t & 3));
    if ((t & 3) == 3) {
      o[t >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
    const int i2 = i - (is_n || is_nw);
    const int j2 = j - (is_w || is_nw);
    frm = (i2 >= 0 && j2 >= 0)
              ? decode(bpb[(size_t)i2 * G + j2], next_plane(frm)) : 0;
    i = i2;
    j = j2;
    ++t;
  }
  int q = t >> 2;
  if (t & 3) o[q++] = static_cast<uint8_t>(acc);
  for (; q < W; ++q) o[q] = 0;
  int32_t* p = packed + (size_t)b * 10;
  p[0] = score[b];
  p[1] = i0;
  p[2] = j0;
  p[3] = nops;
  p[4] = cr > 0 ? i0 - cr + 1 : 0;
  p[5] = cg > 0 ? j0 - cg + 1 : 0;
  p[6] = n_match;
  p[7] = n_mis;
  p[8] = n_ins;
  p[9] = n_del;
}

}  // namespace

// genome [B, G] u8, read [B, R] u8, score/max_i/max_j/plane [B] i32,
// bp [B, R, G] u8 -> packed [B, 10] i32, ops [B, (R+G+3)/4] u8. Returns
// cudaGetLastError() after the launch.
extern "C" int ls_traceback_launch(const void* genome, const void* read,
                                   const void* score, const void* max_i,
                                   const void* max_j, const void* plane,
                                   const void* bp, void* packed, void* ops,
                                   int B, int G, int R, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  ls_traceback_kernel<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(genome), static_cast<const uint8_t*>(read),
      i32(score), i32(max_i), i32(max_j), i32(plane),
      static_cast<const uint8_t*>(bp), static_cast<int32_t*>(packed),
      static_cast<uint8_t*>(ops), B, G, R);
  return static_cast<int>(cudaGetLastError());
}
