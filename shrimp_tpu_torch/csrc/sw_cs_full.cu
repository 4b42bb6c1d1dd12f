// Colour-space full Smith-Waterman DP (filter 3), hand-written for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel shrimp_tpu/core/sw_cs_full_pallas.py::
// _kernel, reached through sw_full_cs_dp_pallas. The 4-layer banded DP of
// sw-full-cs.c: the colour read is translated into four letter reads (one
// per possible initial letter), each layer runs the (NW, N, W) affine DP
// against the letter window, and moving between layers from one row to
// the next costs that row's crossover penalty. Outputs are bit-equal to
// sw_full_cs_dp_pallas: best, bi, bj, bk, bfrm per pair and the packed
// backpointers nw | n << 5 | w << 10 of every cell, including the
// candidate order and its ties (own layer first, then the others in
// ascending order, plane order reversed under revcmpl, strict > scans),
// the per-row local inits, the taboo near the read end, the W chain's
// FILL floor and the best-cell picks.
//
// What bounds it on an H100: integer ALU and shared-memory issue. A cell
// of one layer weighs 12 NW and 8 N candidates plus the W chain, about
// 60 int32 operations, and each reads the previous row of all four
// layers; a launch computes 4*B*R*G of them. Device memory carries the
// backpointers out, 2 bytes per layer-cell (B = 2048, G = 64, R = 36:
// 37.7 MB), which the card writes in microseconds. The main path's
// launches are small (2048 pairs), so the design must fill 132 SMs from
// 2048 pairs.
//
// What the design does about it: one warp per (window, read) pair and
// PAIRS warps per block, so a 2048-pair launch is 2048 warps, about 15
// per SM. Lane = (layer k = lane / 8, column strip s = lane % 8); a strip
// is S = GMAX / 8 consecutive columns (the G bucket is a template
// parameter). The previous and the current row of all 4 layers x 3
// planes live in shared memory as ping-pong buffers, so no lane orders
// its reads against another's writes within a row. Slots are padded (one
// spare int after every strip, a layer stride of GMAX + 8 = 8 mod 32) so
// that the 32 lanes' loads of one column step fall in 32 distinct banks.
// A row runs in two passes: (1) NW and N from the previous row, which
// also gathers the strip's maximum of the W chain terms a_j + j*gea from
// the nw values it has just computed; a 3-step __shfl_up_sync max scan
// over the 8 lanes of each layer gives the strip's carry; (2) the W
// plane from that carry, its from-codes and the lane's best cell. The
// row's best cell is reduced over all 32 lanes on (value larger, then j
// smaller, then k smaller), which is the reference's first (j, then k)
// holding the row's maximum. Backpointers are int16 [B, R, 4, G],
// pair-major as the reference lays them out: a row's 4 x G values are
// one contiguous run, and each lane stores its strip from registers in
// 16-byte pieces, in lane order. Every cell is computed, in band or not;
// out-of-band cells take their init values as in the reference.
//
// Windows wider than 256 (CS reads over about 180 colours: G = 352 at
// 250 colours, 1408 at 1000) take a second kernel, a block of up to 16
// warps per pair, a lane per column in all four layers
// (sw_cs_full_wide_kernel, below). A row computes only the 32-column
// chunks that meet its band and the columns the next row reads, split
// among the warps; the rest of its backpointers are zeros. Each source
// layer's NW trio and N pair of candidates is scanned once per column
// and merged for the four layers, the N candidates' column j comes
// from the right-hand lane by shuffle, and the W chain crosses warps as
// each warp's maximum of its terms, combined after a block barrier.
// Its row buffers and pass 1's from-codes, about 105 bytes a column, sit
// in shared memory up to about 2,200 columns (the 227 KB a block can opt
// into), in a device-memory scratch that the caller allocates past that.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

constexpr int NEG = -(1 << 25);
constexpr int FILL = -(1 << 28);
constexpr int BASE_N = 15;
constexpr int PAIRS = 4;   // warps, one pair each, per block
constexpr unsigned FULL_MASK = 0xffffffffu;
// direction-pair codes of sw-full-cs.c; a backpointer is code << 2 | layer
constexpr int NN = 1, NNW = 2, WNW = 3, WW = 4, NWN = 5, NWNW = 6, NWW = 7;

// The strict-> candidate scan: the first candidate is always taken
// (every candidate exceeds INT_MIN), later ones only when greater.
struct Best {
  int val = INT_MIN;
  int bk = 0;
  __device__ __forceinline__ void take(int c, int code, int layer) {
    if (c > val) {
      val = c;
      bk = code << 2 | layer;
    }
  }
};

// The strict-> scan over the groups of layer k's candidates in the order
// [k, the others ascending], from each group's own scan: a group's first
// maximum is the first maximum of its candidates, so scanning group
// results in that order equals scanning every candidate in it.
__device__ __forceinline__ Best in_order(const Best (&grp)[4], int k) {
  Best r = grp[0];
#pragma unroll
  for (int l = 1; l < 4; ++l)
    if (l == k) r = grp[l];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (l != k && grp[l].val > r.val) r = grp[l];
  return r;
}

// Shared memory of one pair in the G bucket GMAX: two row buffers of
// 3 planes x 4 layers x L slots, then the genome window. Column j of a
// layer sits in slot 1 + j + j / S (slot 0 is the pad column j = -1).
template <int GMAX>
struct Geo {
  static constexpr int S = GMAX / 8;         // strip width
  static constexpr int L = GMAX + 8;         // layer stride, 8 mod 32
  static constexpr int PLANE = 4 * L;
  static constexpr int BUF = 3 * PLANE;
  static constexpr int INTS = 2 * BUF + GMAX / 4;
  static constexpr int BYTES = 4 * INTS;
};

template <int GMAX>
__global__ void __launch_bounds__(32 * PAIRS)
sw_cs_full_kernel(const uint8_t* __restrict__ genome,
                  const uint8_t* __restrict__ qr,
                  const int32_t* __restrict__ xover,
                  const int32_t* __restrict__ gx_,
                  const int32_t* __restrict__ glen_,
                  const int32_t* __restrict__ rlen_,
                  const int32_t* __restrict__ ax_,
                  const int32_t* __restrict__ ay_,
                  const int32_t* __restrict__ alen_,
                  const int32_t* __restrict__ awid_,
                  const int32_t* __restrict__ rev_,
                  int16_t* __restrict__ bp, int32_t* __restrict__ stats,
                  int B, int G, int R, int m, int mm, int goa, int gea,
                  int gob, int geb, int local, int taboo) {
  using Gm = Geo<GMAX>;
  constexpr int S = Gm::S, L = Gm::L, PLANE = Gm::PLANE;
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * PAIRS + warp;
  if (b >= B) return;
  int* prev = reinterpret_cast<int*>(smem) + warp * Gm::INTS;
  int* cur = prev + Gm::BUF;
  uint8_t* gsh = reinterpret_cast<uint8_t*>(prev + 2 * Gm::BUF);

  const int k = lane >> 3, s = lane & 7;
  const int j0 = s * S;           // the strip is [j0, j0 + S) below G
  const uint8_t* q = qr + (size_t)b * 4 * R + (size_t)k * R;
  const int32_t* xr = xover + (size_t)b * R;
  const int gl = glen_[b], rl = rlen_[b];
  const int ax = ax_[b], ay = ay_[b], alen = alen_[b], awid = awid_[b];
  const bool rv = rev_[b] != 0;
  const int gx = gx_[b];

  for (int j = lane; j < G; j += 32) gsh[j] = genome[(size_t)b * G + j];
  // row -1 starts layer 0 at 0 and layers 1..3 at the global crossover,
  // with the N and W planes offset by the gap opens, in every slot
  for (int x = lane; x < PLANE; x += 32) {
    const int off = x < L ? 0 : gx;
    prev[x] = off;
    prev[PLANE + x] = off - gob;
    prev[2 * PLANE + x] = off - goa;
  }
  __syncwarp();

  int best = 0, bi = 0, bj = 0, bk = 0, bfrm = 0;
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
    const int xc = xr[i];
    // taboo: no N-plane entry (or exit to NW) near the read end
    const bool no_taboo = taboo == 0 || i < rl - taboo;
    const bool rec = local ? i < rl : i == rl - 1;
    const int init_nw = local ? (k == 0 ? 0 : xc) : NEG;
    const int init_n = local ? init_nw - gob : NEG;
    const int init_w = local ? init_nw - goa : NEG;
    const int qk = q[i];
    if (s == 0) {   // this row's pad column j = -1
      cur[k * L] = init_nw;
      cur[PLANE + k * L] = init_n;
      cur[2 * PLANE + k * L] = init_w;
    }

    // ---- pass 1: NW and N of layer k over the strip, from the previous
    // row of all four layers; d_* hold column j - 1, u_* column j
    int d_nw[4], d_n[4], d_w[4];
    const int sl1 = j0 + s + 1;              // slot of column j0
    const int sl0 = s == 0 ? 0 : sl1 - 2;    // slot of column j0 - 1
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      d_nw[l] = prev[l * L + sl0];
      d_n[l] = prev[PLANE + l * L + sl0];
      d_w[l] = prev[2 * PLANE + l * L + sl0];
    }
    uint32_t bpv[S / 2];   // the strip's backpointers, two per word
    int agg = FILL;        // max of the W chain terms of columns > j0
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      if (j < G) {
        const int sl = sl1 + t;
        int u_nw[4], u_n[4], u_w[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          u_nw[l] = prev[l * L + sl];
          u_n[l] = prev[PLANE + l * L + sl];
          u_w[l] = prev[2 * PLANE + l * L + sl];
        }
        const bool inb = j >= x_min && j <= x_max;
        // NW: 12 candidates, groups in layer order [k, others ascending],
        // groups after the first pay the crossover. Each layer's group is
        // scanned on its own (layer indices stay compile-time, so the
        // arrays stay in registers), then the groups in that order.
        Best grp[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int x = l == k ? 0 : xc;
          const int c_n = no_taboo ? d_n[l] + x : 2 * NEG;
          if (rv) {
            grp[l].take(d_w[l] + x, NWW, l);
            grp[l].take(c_n, NWN, l);
            grp[l].take(d_nw[l] + x, NWNW, l);
          } else {
            grp[l].take(d_nw[l] + x, NWNW, l);
            grp[l].take(c_n, NWN, l);
            grp[l].take(d_w[l] + x, NWW, l);
          }
        }
        const Best nw = in_order(grp, k);
        const int gch = gsh[j];
        const int sc = (gch == BASE_N || qk == BASE_N) ? 0
                                                       : (gch == qk ? m : mm);
        int nw_val = nw.val + sc, nw_bk = nw.bk;
        if (local && nw_val <= init_nw) {
          nw_val = init_nw;
          nw_bk = 0;
        }
        if (!inb) {
          nw_val = init_nw;
          nw_bk = 0;
        }

        // N: 8 candidates (open, extend) per layer group, in the same
        // group order
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int x = l == k ? 0 : xc;
          const int c_open = no_taboo ? u_nw[l] - gob - geb + x : 2 * NEG;
          const int c_ext = u_n[l] - geb + x;
          grp[l] = Best();
          if (rv) {
            grp[l].take(c_ext, NN, l);
            grp[l].take(c_open, NNW, l);
          } else {
            grp[l].take(c_open, NNW, l);
            grp[l].take(c_ext, NN, l);
          }
        }
        const Best n = in_order(grp, k);
        int n_val = n.val, n_bk = n.bk;
        if (local && n_val <= init_nw) {
          n_val = init_nw;
          n_bk = 0;
        }
        if (!inb) {
          n_val = init_n;
          n_bk = 0;
        }
        cur[k * L + sl] = nw_val;
        cur[PLANE + k * L + sl] = n_val;
        const uint32_t v = static_cast<uint32_t>(nw_bk | n_bk << 5);
        if (t & 1)
          bpv[t >> 1] |= v << 16;
        else
          bpv[t >> 1] = v;

        // the W chain term of column j + 1, whose left nw is nw_val
        const int jn = j + 1;
        if (t + 1 < S && jn < G && jn >= x_min && jn <= x_max) {
          int a = no_taboo ? nw_val - goa - gea : 2 * NEG;
          if (local) a = max(a, init_nw);
          if (jn == x_min) a = max(a, init_w - gea);
          agg = max(agg, a + jn * gea);
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          d_nw[l] = u_nw[l];
          d_n[l] = u_n[l];
          d_w[l] = u_w[l];
        }
      }
    }
    __syncwarp();

    // the term of column j0, whose left nw is the neighbour strip's last
    // (or the pad column); then the carry from the strips to the left:
    // the W chain's running max after column j0 - 1, floored at FILL
    int left_nw = cur[k * L + sl0];
    if (j0 < G && j0 >= x_min && j0 <= x_max) {
      int a = no_taboo ? left_nw - goa - gea : 2 * NEG;
      if (local) a = max(a, init_nw);
      if (j0 == x_min) a = max(a, init_w - gea);
      agg = max(agg, a + j0 * gea);
    }
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, agg, d, 8);
      if (s >= d) agg = max(agg, u);
    }
    int c = __shfl_up_sync(FULL_MASK, agg, 1, 8);
    if (s == 0) c = FILL;

    // ---- pass 2: the W plane, its from-codes and the lane's best cell
    // (first j holding the lane's maximum)
    int w_left = j0 > 0 && j0 - 1 >= x_min && j0 - 1 <= x_max
                     ? c - (j0 - 1) * gea : init_w;
    int rb = NEG, rj = G, rfrm = 0;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      if (j < G) {
        const int sl = sl1 + t;
        const bool inb = j >= x_min && j <= x_max;
        const int nw_val = cur[k * L + sl];
        const int c_open_w = no_taboo ? left_nw - goa - gea : 2 * NEG;
        int a = c_open_w;
        if (local) a = max(a, init_nw);
        if (j == x_min) a = max(a, init_w - gea);
        c = max(c, inb ? a + j * gea : FILL);
        const int w_raw = inb ? c - j * gea : init_w;
        const int c_ext_w = w_left - gea;
        const bool take_ext = rv ? !(c_open_w > c_ext_w) : c_ext_w > c_open_w;
        int w_val = w_raw;
        int w_bk = (take_ext ? WW : WNW) << 2 | k;
        if (local && w_raw <= init_nw) {
          w_val = init_nw;
          w_bk = 0;
        }
        if (!inb) w_bk = 0;
        w_left = w_raw;
        left_nw = nw_val;
        cur[2 * PLANE + k * L + sl] = w_val;
        const uint32_t v = (bpv[t >> 1] >> (16 * (t & 1))) & 0x3ffu;
        bpv[t >> 1] |= static_cast<uint32_t>(w_bk << 10) << (16 * (t & 1));

        if (rec && inb) {
          const int n_val = cur[PLANE + k * L + sl];
          const int cm = max(max(nw_val, n_val), w_val);
          if (cm > rb) {
            rb = cm;
            rj = j;
            // the reference picks max(value, NEG) at the selected cell,
            // then prefers nw, w if strictly greater, then n
            const int nw_c = max(nw_val, NEG), n_c = max(n_val, NEG),
                      w_c = max(w_val, NEG);
            int frm = static_cast<int>(v & 31), fs = nw_c;
            if (w_c > fs) frm = w_bk;
            fs = max(fs, w_c);
            if (n_c > fs) frm = static_cast<int>(v >> 5);
            rfrm = frm;
          }
        }
      }
    }

    // the row's best cell: largest value, then smallest j, then smallest
    // k; across rows the strict > keeps the earliest row
    if (rec) {
      int rk = k;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const int v2 = __shfl_xor_sync(FULL_MASK, rb, d);
        const int j2 = __shfl_xor_sync(FULL_MASK, rj, d);
        const int k2 = __shfl_xor_sync(FULL_MASK, rk, d);
        const int f2 = __shfl_xor_sync(FULL_MASK, rfrm, d);
        if (v2 > rb || (v2 == rb && (j2 < rj || (j2 == rj && k2 < rk)))) {
          rb = v2;
          rj = j2;
          rk = k2;
          rfrm = f2;
        }
      }
      if (rb > best) {
        best = rb;
        bi = i;
        bj = rj;
        bk = rk;
        bfrm = rfrm;
      }
    }

    // the strip's backpointers: row i, layer k, columns [j0, j0 + S)
    int16_t* dst = bp + (((size_t)b * R + i) * 4 + k) * G + j0;
    const bool vec = (G & 7) == 0;
#pragma unroll
    for (int p = 0; p < S / 8; ++p) {
      const int jc = j0 + 8 * p;
      if (vec && jc + 8 <= G) {
        reinterpret_cast<int4*>(dst)[p] = make_int4(
            static_cast<int>(bpv[4 * p]), static_cast<int>(bpv[4 * p + 1]),
            static_cast<int>(bpv[4 * p + 2]),
            static_cast<int>(bpv[4 * p + 3]));
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (jc + u < G)
            dst[8 * p + u] = static_cast<int16_t>(
                bpv[4 * p + u / 2] >> (16 * (u & 1)));
      }
    }
    __syncwarp();
    int* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (lane == 0) {
    stats[b] = best;
    stats[B + b] = bi;
    stats[2 * B + b] = bj;
    stats[3 * B + b] = bk;
    stats[4 * B + b] = bfrm;
  }
}

// ---- windows wider than 256: the wide kernel

// int32 of one pair's row buffers in the wide kernel: the previous and
// the current row, 3 planes x 4 layers, each layer G + 1 slots (slot 0
// is the pad column j = -1, slot 1 + j column j)
__host__ __device__ inline long long wide_row_ints(int G) {
  return 2LL * 12 * (G + 1);
}
// bytes of one pair's working set in device memory: the row buffers and
// pass 1's from-codes (int16, 4 layers x G)
__host__ __device__ inline long long wide_scratch_bytes(int G) {
  return 4 * wide_row_ints(G) + 16LL * ((G + 1) / 2);
}
// bytes of one pair's shared memory: that working set and the window
__host__ __device__ inline long long wide_pair_bytes(int G) {
  return wide_scratch_bytes(G) + ((G + 15) & ~15);
}

// the band of row i (anchor_get_x_range), clipped to [0, glen - 1]
__device__ __forceinline__ void row_band(int i, int ax, int ay, int alen,
                                         int awid, int gl, int* x_min,
                                         int* x_max) {
  int lo = i < ay ? 0 : (i <= ay + alen - 1 ? ax + (i - ay) : ax + alen);
  *x_min = min(max(lo, 0), gl - 1);
  const int ay2 = ay - (awid - 1);
  int hi = i < ay2 ? ax + awid - 2
                   : (i <= ay2 + alen - 1 ? ax + (awid - 1) + (i - ay2)
                                          : gl - 1);
  *x_max = min(max(hi, 0), gl - 1);
}

// Zeros the int16 columns [from, to) of one backpointer row, thread t of
// n: 16-byte stores where the row is 16-byte aligned.
__device__ __forceinline__ void zero_cols(int16_t* row, int from, int to,
                                          int t, int n) {
  int a = from, e = from;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    a = min((from + 7) & ~7, to);
    e = max(to & ~7, a);
    for (int p = a / 8 + t; p < e / 8; p += n)
      reinterpret_cast<int4*>(row)[p] = make_int4(0, 0, 0, 0);
  }
  for (int j = from + t; j < a; j += n) row[j] = 0;
  for (int j = e + t; j < to; j += n) row[j] = 0;
}

// The row-0-first order of the best cell: value larger, then row, column
// and layer smaller (row -1: the start, value 0 at (0, 0, 0))
struct Pick {
  int v, i, j, k, frm;
  __device__ __forceinline__ bool beats(const Pick& o) const {
    return v > o.v || (v == o.v && (i < o.i || (i == o.i && (j < o.j
           || (j == o.j && k < o.k)))));
  }
};

// The strict-> merge of the four per-layer group results for layer k, in
// the order [k, the others ascending], the others paying the crossover x:
// each group's candidates share its offset, so its own first maximum
// stands for all of them (its taboo candidate, 2 * NEG without the
// offset, lies far below every reachable value and never is one).
__device__ __forceinline__ Best merge(const Best (&grp)[4], int k, int x) {
  Best r = grp[0];
#pragma unroll
  for (int l = 1; l < 4; ++l)
    if (l == k) r = grp[l];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (l != k && grp[l].val + x > r.val) {
      r.val = grp[l].val + x;
      r.bk = grp[l].bk;
    }
  return r;
}

// The 4-layer DP of one pair on NG warps, for any G: the recurrence and
// the candidate order of sw_cs_full_kernel. A row covers only the chunks
// of 32 columns that meet [lo, hi]: its band and the columns the next
// row reads (its band and one column left of it, whose out-of-band
// values depend on the row's crossover in local mode); they are split
// among the warps (column groups), lane l of a chunk on column 32c + l
// in all four layers, and the rest of the row's backpointers are zeros.
// Pass 1: NW and N from the previous row (column j - 1 loaded, column j
// from the lane to the right by shuffle): each source layer's trio (NW)
// and pair (N) of candidates scanned once, then merged for each of the
// four layers; the from-codes kept in shared memory, and each group's
// maximum of the W chain terms a_j + j*gea of each layer. A block
// barrier; a layer's W chain enters a group with the maximum over the
// groups to its left (and each such group's first column, whose left nw
// only then is known). Pass 2: each layer's W plane by a max scan over
// the chunk on that carry, the backpointers out in 64-byte warp stores,
// and each lane's best cell, which it keeps across rows (it meets its
// cells in row, column and layer order) and which the block reduces
// once at the end. A block barrier ends the row. The row buffers and
// the codes sit in shared memory while one pair fits a block (GLOBAL
// false), past that in a device-memory scratch of wide_scratch_bytes(G)
// a pair, the window read from device memory.
template <int NG, bool GLOBAL>
__global__ void __launch_bounds__(32 * NG)
sw_cs_full_wide_kernel(const uint8_t* __restrict__ genome,
                       const uint8_t* __restrict__ qr,
                       const int32_t* __restrict__ xover,
                       const int32_t* __restrict__ gx_,
                       const int32_t* __restrict__ glen_,
                       const int32_t* __restrict__ rlen_,
                       const int32_t* __restrict__ ax_,
                       const int32_t* __restrict__ ay_,
                       const int32_t* __restrict__ alen_,
                       const int32_t* __restrict__ awid_,
                       const int32_t* __restrict__ rev_,
                       int16_t* __restrict__ bp, int32_t* __restrict__ stats,
                       uint8_t* __restrict__ scratch, int B, int G, int R,
                       int m, int mm, int goa, int gea, int gob, int geb,
                       int local, int taboo) {
  extern __shared__ int4 smem[];
  __shared__ int aggs[4][NG];
  __shared__ Pick picks[NG];
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;   // group
  const int b = blockIdx.x;
  const int L = G + 1, PLANE = 4 * L, BUF = 3 * PLANE;
  uint8_t* base = GLOBAL ? scratch + (size_t)b * wide_scratch_bytes(G)
                         : reinterpret_cast<uint8_t*>(smem);
  int* prev = reinterpret_cast<int*>(base);
  int* cur = prev + BUF;
  int16_t* code = reinterpret_cast<int16_t*>(prev + 2 * BUF);  // [4, G]
  const uint8_t* gsh;
  if (GLOBAL) {
    gsh = genome + (size_t)b * G;
  } else {
    uint8_t* gs = base + wide_scratch_bytes(G);
    for (int j = threadIdx.x; j < G; j += blockDim.x)
      gs[j] = genome[(size_t)b * G + j];
    gsh = gs;
  }
  const uint8_t* q = qr + (size_t)b * 4 * R;
  const int32_t* xr = xover + (size_t)b * R;
  const int gl = glen_[b], rl = rlen_[b];
  const int ax = ax_[b], ay = ay_[b], alen = alen_[b], awid = awid_[b];
  const bool rv = rev_[b] != 0;
  const int gx = gx_[b];

  // row -1 starts layer 0 at 0 and layers 1..3 at the global crossover,
  // with the N and W planes offset by the gap opens, in every slot
  for (int x = threadIdx.x; x < PLANE; x += blockDim.x) {
    const int off = x < L ? 0 : gx;
    prev[x] = off;
    prev[PLANE + x] = off - gob;
    prev[2 * PLANE + x] = off - goa;
  }
  __syncthreads();

  Pick best{0, -1, 0, 0, 0};   // the lane's best cell over the rows so far
  for (int i = 0; i < R; ++i) {
    int x_min, x_max, n_min, n_max;
    row_band(i, ax, ay, alen, awid, gl, &x_min, &x_max);
    row_band(i + 1, ax, ay, alen, awid, gl, &n_min, &n_max);
    // the columns this row writes: its band and the next row's reads
    int lo = max(min(x_min, n_min - 1), 0), hi = min(max(x_max, n_max), G - 1);
    // keep the bounds opaque to the optimizer (the ptxas min/max fold of
    // banded_sw.cuh)
    asm volatile("" : "+r"(x_min), "+r"(x_max), "+r"(lo), "+r"(hi));
    const int c_lo = lo >> 5;
    const int nc = hi >= lo ? (hi >> 5) - c_lo + 1 : 0;
    // this group's chunks [c0, c1); the first group with chunks starts
    // the row's W chains from the out-of-band values at its left
    const int c0 = c_lo + g * nc / NG, c1 = c_lo + (g + 1) * nc / NG;
    const bool first = c0 == c_lo;
    const int xc = xr[i];
    // taboo: no N-plane entry (or exit to NW) near the read end
    const bool no_taboo = taboo == 0 || i < rl - taboo;
    const bool rec = local ? i < rl : i == rl - 1;
    int init_nw[4], qk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      init_nw[k] = local ? (k == 0 ? 0 : xc) : NEG;
      qk[k] = q[k * R + i];
    }
    if (g == 0 && lane < 4) {   // this row's pad column j = -1
      const int v = local ? (lane == 0 ? 0 : xc) : NEG;
      cur[lane * L] = v;
      cur[PLANE + lane * L] = local ? v - gob : NEG;
      cur[2 * PLANE + lane * L] = local ? v - goa : NEG;
    }
    // the W chain term of layer k's column j in band from its left nw
    auto term = [&](int k, int left_nw, int j) {
      const int init_w = local ? init_nw[k] - goa : NEG;
      int a = no_taboo ? left_nw - goa - gea : 2 * NEG;
      if (local) a = max(a, init_nw[k]);
      if (j == x_min) a = max(a, init_w - gea);
      return a + j * gea;
    };

    // ---- pass 1: NW and N of the four layers, the codes, the terms
    int agg[4], carry_nw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      agg[k] = FILL;
      carry_nw[k] = init_nw[k];
    }
    for (int c = c0; c < c1; ++c) {
      const int j = 32 * c + lane;
      const bool inb = j < G && j >= x_min && j <= x_max;
      // each source layer's candidates from the previous row's column
      // j - 1 (slot j) and column j (slot j + 1: the right-hand lane's
      // column j - 1), scanned once
      Best tri[4], duo[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const bool in = j <= G;
        const int d_nw = in ? prev[l * L + j] : 0;
        const int d_n = in ? prev[PLANE + l * L + j] : 0;
        const int d_w = in ? prev[2 * PLANE + l * L + j] : 0;
        int u_nw = __shfl_down_sync(FULL_MASK, d_nw, 1);
        int u_n = __shfl_down_sync(FULL_MASK, d_n, 1);
        if (lane == 31 && j < G) {
          u_nw = prev[l * L + j + 1];
          u_n = prev[PLANE + l * L + j + 1];
        }
        const int c_n = no_taboo ? d_n : 2 * NEG;
        if (rv) {
          tri[l].take(d_w, NWW, l);
          tri[l].take(c_n, NWN, l);
          tri[l].take(d_nw, NWNW, l);
        } else {
          tri[l].take(d_nw, NWNW, l);
          tri[l].take(c_n, NWN, l);
          tri[l].take(d_w, NWW, l);
        }
        const int c_open = no_taboo ? u_nw - gob - geb : 2 * NEG;
        const int c_ext = u_n - geb;
        if (rv) {
          duo[l].take(c_ext, NN, l);
          duo[l].take(c_open, NNW, l);
        } else {
          duo[l].take(c_open, NNW, l);
          duo[l].take(c_ext, NN, l);
        }
      }
      const int gch = j < G ? gsh[j] : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int nw_val = init_nw[k], n_val = local ? init_nw[k] - gob : NEG;
        int codes = 0;
        if (inb) {
          const Best nw = merge(tri, k, xc);
          const int sc = (gch == BASE_N || qk[k] == BASE_N)
                             ? 0 : (gch == qk[k] ? m : mm);
          nw_val = nw.val + sc;
          int nw_bk = nw.bk;
          if (local && nw_val <= init_nw[k]) {
            nw_val = init_nw[k];
            nw_bk = 0;
          }
          const Best n = merge(duo, k, xc);
          n_val = n.val;
          int n_bk = n.bk;
          if (local && n_val <= init_nw[k]) {
            n_val = init_nw[k];
            n_bk = 0;
          }
          codes = nw_bk | n_bk << 5;
        }
        if (j < G) {
          cur[k * L + j + 1] = nw_val;
          cur[PLANE + k * L + j + 1] = n_val;
          code[k * G + j] = static_cast<int16_t>(codes);
        }
        // the term of column j; a later group's first column waits for
        // its left nw
        int left_nw = __shfl_up_sync(FULL_MASK, nw_val, 1);
        if (lane == 0) left_nw = carry_nw[k];
        if (inb && (first || c > c0 || lane > 0))
          agg[k] = max(agg[k], term(k, left_nw, j));
        carry_nw[k] = __shfl_sync(FULL_MASK, nw_val, 31);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      agg[k] = __reduce_max_sync(FULL_MASK, agg[k]);
      if (lane == 0) aggs[k][g] = agg[k];
    }
    // the groups' nw and terms, then the outside of [lo, hi]: zeros
    if (NG > 1)
      __syncthreads();
    else
      __syncwarp();
    int16_t* bprow = bp + ((size_t)b * R + i) * 4 * G;
    const int z0 = nc == 0 ? G : 32 * c_lo;
    const int z1 = nc == 0 ? G : min(32 * (c_lo + nc), G);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      zero_cols(bprow + k * G, 0, z0, threadIdx.x, 32 * NG);
      zero_cols(bprow + k * G, z1, G, threadIdx.x, 32 * NG);
    }

    // ---- each layer's carry into the group: the W chain's running max
    // over the columns left of it, and that column's nw and raw w
    int carry_c[4], carry_w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      carry_c[k] = FILL;
      carry_w[k] = local ? init_nw[k] - goa : NEG;
      carry_nw[k] = init_nw[k];
    }
    if (!first && c0 < c1) {
      const int js = 32 * c0;   // column js - 1 is the left group's last
      // group `lane`'s first column, when it is not the row's first
      const int l0 = c_lo + lane * nc / NG, l1 = c_lo + (lane + 1) * nc / NG;
      const int jf = 32 * l0;
      const bool own = lane < g && l0 > c_lo && l0 < l1 && jf >= x_min
                       && jf <= x_max;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int v = lane < g ? aggs[k][lane] : FILL;
        if (own) v = max(v, term(k, cur[k * L + jf], jf));
        carry_c[k] = __reduce_max_sync(FULL_MASK, v);
        carry_nw[k] = cur[k * L + js];
        if (js - 1 >= x_min && js - 1 <= x_max)
          carry_w[k] = carry_c[k] - (js - 1) * gea;
      }
    }

    // ---- pass 2: the W planes, the backpointers, the lane's best cell
    for (int c = c0; c < c1; ++c) {
      const int j = 32 * c + lane;
      const bool inb = j < G && j >= x_min && j <= x_max;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int init_w = local ? init_nw[k] - goa : NEG;
        const int nw_val = j < G ? cur[k * L + j + 1] : init_nw[k];
        int left_nw = __shfl_up_sync(FULL_MASK, nw_val, 1);
        if (lane == 0) left_nw = carry_nw[k];
        const int c_open_w = no_taboo ? left_nw - goa - gea : 2 * NEG;
        int cc = inb ? term(k, left_nw, j) : FILL;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(FULL_MASK, cc, d);
          if (lane >= d) cc = max(cc, u);
        }
        cc = max(cc, carry_c[k]);
        const int w_raw = inb ? cc - j * gea : init_w;
        int w_left = __shfl_up_sync(FULL_MASK, w_raw, 1);
        if (lane == 0) w_left = carry_w[k];
        const int c_ext_w = w_left - gea;
        const bool take_ext = rv ? !(c_open_w > c_ext_w)
                                 : c_ext_w > c_open_w;
        int w_val = w_raw;
        int w_bk = (take_ext ? WW : WNW) << 2 | k;
        if (local && w_raw <= init_nw[k]) {
          w_val = init_nw[k];
          w_bk = 0;
        }
        if (!inb) w_bk = 0;
        carry_c[k] = __shfl_sync(FULL_MASK, cc, 31);
        carry_nw[k] = __shfl_sync(FULL_MASK, nw_val, 31);
        carry_w[k] = __shfl_sync(FULL_MASK, w_raw, 31);
        if (j < G) {
          cur[2 * PLANE + k * L + j + 1] = w_val;
          const int codes = code[k * G + j];
          bprow[k * G + j] = static_cast<int16_t>(codes | w_bk << 10);
          if (rec && inb) {
            const int n_val = cur[PLANE + k * L + j + 1];
            const int cm = max(max(nw_val, n_val), w_val);
            if (cm > best.v) {
              // the reference picks max(value, NEG) at the selected
              // cell, then prefers nw, w if strictly greater, then n
              const int nw_c = max(nw_val, NEG), n_c = max(n_val, NEG),
                        w_c = max(w_val, NEG);
              int frm = codes & 31, fs = nw_c;
              if (w_c > fs) frm = w_bk;
              fs = max(fs, w_c);
              if (n_c > fs) frm = codes >> 5;
              best = Pick{cm, i, j, k, frm};
            }
          }
        }
      }
    }
    __syncthreads();
    int* tmp = prev;
    prev = cur;
    cur = tmp;
  }

  // the best cell: largest value, then the first row, column and layer
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Pick o{__shfl_xor_sync(FULL_MASK, best.v, d),
                 __shfl_xor_sync(FULL_MASK, best.i, d),
                 __shfl_xor_sync(FULL_MASK, best.j, d),
                 __shfl_xor_sync(FULL_MASK, best.k, d),
                 __shfl_xor_sync(FULL_MASK, best.frm, d)};
    if (o.beats(best)) best = o;
  }
  if (lane == 0) picks[g] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NG; ++w)
      if (picks[w].beats(best)) best = picks[w];
    const bool any = best.i >= 0;
    stats[b] = any ? best.v : 0;
    stats[B + b] = any ? best.i : 0;
    stats[2 * B + b] = any ? best.j : 0;
    stats[3 * B + b] = any ? best.k : 0;
    stats[4 * B + b] = any ? best.frm : 0;
  }
}

// Warps (column groups) a pair of the wide kernel for windows G wide: 4,
// 8 or 16, the most with at least two chunks of 32 columns a warp (a
// window over 256 columns has at least 9). A pair's row buffers (about
// 105 bytes a column) hold a block to 6 pairs an SM at G = 352 and 1 at
// G = 1408, so the warps a pair, not the launch's B, decide how many
// warps an SM runs.
inline int wide_groups(int G) {
  const int chunks = (G + 31) / 32;
  return chunks >= 32 ? 16 : chunks >= 16 ? 8 : 4;
}

template <bool GLOBAL>
using WideKernel = decltype(&sw_cs_full_wide_kernel<4, GLOBAL>);

template <bool GLOBAL>
WideKernel<GLOBAL> wide_kernel(int ng) {
  return ng == 4 ? sw_cs_full_wide_kernel<4, GLOBAL>
                 : ng == 8 ? sw_cs_full_wide_kernel<8, GLOBAL>
                           : sw_cs_full_wide_kernel<16, GLOBAL>;
}

// The wide kernel's launch for windows G wide: threads per block (one
// pair, a warp a column group), its dynamic shared memory, and whether
// the row buffers go to device memory (one pair's do not fit a block);
// sets the shared memory limit above 48 KB.
cudaError_t wide_prepare(int G, int* threads, int* smem, bool* global) {
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  const int ng = wide_groups(G);
  *threads = 32 * ng;
  // the static shared memory: aggs and picks
  const long long fixed = 16LL * ng + ng * sizeof(Pick);
  *global = wide_pair_bytes(G) + fixed > optin;
  *smem = *global ? 0 : static_cast<int>(wide_pair_bytes(G));
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(wide_kernel<false>(ng),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

cudaError_t launch_wide(const void* const* in, void* bp, void* stats,
                        void* scratch, int B, int G, int R, int m, int mm,
                        int goa, int gea, int gob, int geb, int local,
                        int taboo, cudaStream_t stream) {
  int threads = 32, smem = 0;
  bool global = false;
  cudaError_t e = wide_prepare(G, &threads, &smem, &global);
  if (e != cudaSuccess) return e;
  if (global && scratch == nullptr) return cudaErrorInvalidValue;
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto kernel = global ? wide_kernel<true>(threads / 32)
                       : wide_kernel<false>(threads / 32);
  kernel<<<B, threads, smem, stream>>>(
      u8(in[0]), u8(in[1]), i32(in[2]), i32(in[3]), i32(in[4]), i32(in[5]),
      i32(in[6]), i32(in[7]), i32(in[8]), i32(in[9]), i32(in[10]),
      static_cast<int16_t*>(bp), static_cast<int32_t*>(stats),
      static_cast<uint8_t*>(scratch), B, G, R, m, mm, goa, gea, gob, geb,
      local, taboo);
  return cudaGetLastError();
}

template <int GMAX>
cudaError_t prepare(int* smem) {
  *smem = PAIRS * Geo<GMAX>::BYTES;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sw_cs_full_kernel<GMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <int GMAX>
cudaError_t launch(const void* const* in, void* bp, void* stats, int B,
                   int G, int R, int m, int mm, int goa, int gea, int gob,
                   int geb, int local, int taboo, cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = prepare<GMAX>(&smem);
  if (e != cudaSuccess) return e;
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  sw_cs_full_kernel<GMAX><<<(B + PAIRS - 1) / PAIRS, 32 * PAIRS, smem,
                            stream>>>(
      u8(in[0]), u8(in[1]), i32(in[2]), i32(in[3]), i32(in[4]), i32(in[5]),
      i32(in[6]), i32(in[7]), i32(in[8]), i32(in[9]), i32(in[10]),
      static_cast<int16_t*>(bp), static_cast<int32_t*>(stats), B, G, R, m,
      mm, goa, gea, gob, geb, local, taboo);
  return cudaGetLastError();
}

template <int GMAX>
cudaError_t config(int* out) {
  int smem = 0;
  cudaError_t e = prepare<GMAX>(&smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, sw_cs_full_kernel<GMAX>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sw_cs_full_kernel<GMAX>, 32 * PAIRS, smem);
  out[0] = PAIRS;
  out[1] = 32;
  out[2] = smem;
  out[3] = blocks;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return e;
}

}  // namespace

// genome [B, G] u8 (letters), qr [B, 4, R] u8 (letter layers), xover
// [B, R] i32, gx/glen/rlen/ax/ay/alen/awid/rev [B] i32 -> bp [B, R, 4, G]
// i16, stats [5, B] i32 (best, bi, bj, bk, bfrm). goa/gea/gob/geb are the
// open and extend costs as positive penalties (open NOT including
// extend). G <= 256 takes the strip kernel of its G bucket, wider
// windows the wide kernel; `scratch` is the device memory of
// sw_cs_full_scratch's size (null when that is 0). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for G < 1,
// or a null scratch where the wide kernel needs one).
extern "C" int sw_cs_full_launch(const void* genome, const void* qr,
                                 const void* xover, const void* gx,
                                 const void* glen, const void* rlen,
                                 const void* ax, const void* ay,
                                 const void* alen, const void* awid,
                                 const void* rev, void* bp, void* stats,
                                 int B, int G, int R, int m, int mm, int goa,
                                 int gea, int gob, int geb, int local,
                                 int taboo, void* stream, void* scratch) {
  if (B <= 0) return 0;
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[] = {genome, qr, xover, gx, glen, rlen,
                      ax, ay, alen, awid, rev};
  cudaError_t e;
  if (G <= 64)
    e = launch<64>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb, local,
                   taboo, st);
  else if (G <= 128)
    e = launch<128>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb,
                    local, taboo, st);
  else if (G <= 256)
    e = launch<256>(in, bp, stats, B, G, R, m, mm, goa, gea, gob, geb,
                    local, taboo, st);
  else
    e = launch_wide(in, bp, stats, scratch, B, G, R, m, mm, goa, gea, gob,
                    geb, local, taboo, st);
  return static_cast<int>(e);
}

// The device memory, in bytes, that a launch of B pairs of G columns
// needs beside its outputs, into *(long long*)out: the wide kernel's row
// buffers and codes where one pair's do not fit a block's shared memory,
// else 0. (R is not read; the signature is every <kernel>_scratch's.)
// Returns a cudaError_t.
extern "C" int sw_cs_full_scratch(int B, int G, int R, void* out) {
  (void)R;
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (G <= 256 || B <= 0) return 0;
  int threads = 32, smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(G, &threads, &smem, &global);
  if (global) *o = wide_scratch_bytes(G) * B;
  return static_cast<int>(e);
}

// The launch configuration of B pairs of windows G wide (R is not
// read): out[0..5] = pairs per block, threads per pair, dynamic shared
// memory bytes per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread
// and local (spill) bytes per thread. Returns a cudaError_t.
extern "C" int sw_cs_full_config(int B, int G, int R, void* out) {
  (void)R;
  int* o = static_cast<int*>(out);
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (G <= 64) return static_cast<int>(config<64>(o));
  if (G <= 128) return static_cast<int>(config<128>(o));
  if (G <= 256) return static_cast<int>(config<256>(o));
  int threads = 32, smem = 0;
  bool global = false;
  const cudaError_t e = wide_prepare(G, &threads, &smem, &global);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ng = threads / 32;
  return banded::config(global ? wide_kernel<true>(ng)
                               : wide_kernel<false>(ng),
                        threads, threads, smem, o);
}
