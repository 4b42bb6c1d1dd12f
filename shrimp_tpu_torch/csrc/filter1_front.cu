// Filter 1's front half, hand-written for Hopper (sm_90a): spaced k-mer
// keys, the CSR lookup, the posting gather, the per-owner sort and the
// region filter, for every owner (a read strand) of a batch.
//
// Replaces: no TPU kernel. It moves shrimp_tpu/native/filter1.cpp's
// `collect_owner` (k-mer keys, CSR offsets, postings packed as
// pos << 32 | stream, stream = seed * L + i, sorted) and the anchor
// walk's region test (read_get_region_counts, mapping.c:459-542) from the
// host onto the card, as SURVEY.md section 7.1 planned for the JAX
// package (steps 1-3). Per owner it writes the sorted postings whose
// region has 2 or more marks, or that lie in the overlap of a region
// whose predecessor has: exactly the subsequence of the host's sorted
// pos_keys that the host walk keeps, in the same order. The host runs
// the unchanged back half on them (filter1.cpp's filter1_survivors).
//
// What bounds it on an H100: the latency of random loads. Each key is
// one load from a CSR offset table of 4^weight + 1 uint32 (67 MB a seed
// at weight 12, far beyond the L2), and each non-empty list one more
// from the positions; a 250 bp owner has about 700 keys and 1,000
// postings. The bytes are few (for 8,192 owners of 250 bp, 87 MB of
// offsets, postings and survivors, 0.03 ms at 3.35 TB/s; 0.2 GB at
// 32-byte sectors, 0.06 ms), so the kernel is bound by how many loads it
// keeps in flight.
//
// What the design does about it:
// - A block of 256 threads per owner: every key's offset pair is loaded
//   by its own thread, all at once, and the gather hands each thread
//   postings of many lists (a binary search over the lists' prefix sums
//   in shared memory finds a posting's list), so about 2,000 loads an SM
//   are in flight at 8 blocks an SM.
// - The keys, the lists and the postings stay in shared memory: the
//   postings (at most `cap`, a power of two) sort there with a bitonic
//   network on the whole 64-bit key (the keys are unique, so any correct
//   sort gives the host's order).
// - The region marks need no map: region r has 2 or more marks when the
//   sorted run holds 2 or more postings in [r << bits, (r + 1) << bits
//   + min(overlap, 2^bits)), and a posting lies in that interval, so the
//   test is whether a neighbour in sorted order does too.
// - The survivors are compacted in order with a block scan, at an offset
//   taken with one atomic add per owner; the host reads each owner's
//   (offset, count) from `meta`. An owner over `cap` postings writes
//   count -1 and the host runs its own front half for it.
// - The survivors' buffer is sized for a batch's usual count (a survivor
//   a key: twice what E. coli reads of 36 and 250 bp give), not for the
//   worst case (n_owners * cap, 134 MB at 8,192 owners of 250 bp): a
//   batch that overflows it is run again with the worst case's room.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_sw.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEEDS = 16;
constexpr int MAX_SPAN = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// filter1_front_config's answer where a block cannot hold an owner
constexpr int NO_FIT = -1;

// The index's seeds and their CSR tables on the device (built once a
// mapper, core/filter1_front.py `seed_tables`): offsets[s] holds
// 4^weight[s] + 1 uint32, positions[s] the sorted postings.
struct Seeds {
  int32_t n_seeds;
  int32_t span[MAX_SEEDS];
  int32_t weight[MAX_SEEDS];
  uint8_t offs[MAX_SEEDS][MAX_SPAN];
  uint64_t offsets[MAX_SEEDS];
  uint64_t positions[MAX_SEEDS];
};

// Exclusive prefix of each thread's `v` over the block; `total` gets the
// sum. `wsum` holds a word a warp.
__device__ int block_excl_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < THREADS / 32 ? wsum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, d);
      if (lane >= d) s += y;
    }
    if (lane < THREADS / 32) wsum[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w ? wsum[w - 1] : 0);
  *total = wsum[THREADS / 32 - 1];
  __syncthreads();
  return excl;
}

// A thread's contiguous chunk [b, e) of n items.
__device__ void chunk(int n, int* b, int* e) {
  const int per = (n + THREADS - 1) / THREADS;
  *b = min(n, static_cast<int>(threadIdx.x) * per);
  *e = min(n, *b + per);
}

__global__ void __launch_bounds__(THREADS)
filter1_front_kernel(const uint8_t* __restrict__ codes,
                     const Seeds* __restrict__ seeds,
                     uint64_t* __restrict__ surv,
                     long long* __restrict__ meta, long long surv_cap,
                     int n_owners, int L, int min_pos, int K, int cap,
                     long long cutoff, int rbits, int overlap,
                     int use_region) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Seeds S;
  __shared__ int kbase[MAX_SEEDS + 1];
  __shared__ int wsum[THREADS / 32];
  __shared__ unsigned long long s_base;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_raw);
  int* start = reinterpret_cast<int*>(keys + cap);
  uint32_t* lo = reinterpret_cast<uint32_t*>(start + K + 1);
  uint8_t* code = reinterpret_cast<uint8_t*>(lo + K);
  const int tid = threadIdx.x;
  const int ow = blockIdx.x;

  for (int t = tid; t < static_cast<int>(sizeof(Seeds) / 4); t += THREADS)
    reinterpret_cast<int32_t*>(&S)[t] =
        reinterpret_cast<const int32_t*>(seeds)[t];
  const uint8_t* rc = codes + static_cast<size_t>(ow) * L;
  for (int t = tid; t < L; t += THREADS) code[t] = rc[t] & 3;
  __syncthreads();
  if (tid == 0) {
    int k = 0;
    for (int s = 0; s < S.n_seeds; ++s) {
      kbase[s] = k;
      k += max(0, L - S.span[s] + 1 - min_pos);
    }
    kbase[S.n_seeds] = k;
  }
  __syncthreads();

  // keys and the CSR offsets: one key a thread
  for (int k = tid; k < K; k += THREADS) {
    int s = 0;
    while (k >= kbase[s + 1]) ++s;
    const int i = k - kbase[s] + min_pos;
    uint32_t key = 0;
    for (int j = 0; j < S.weight[s]; ++j)
      key |= static_cast<uint32_t>(code[i + S.offs[s][j]]) << (2 * j);
    const uint32_t* off = reinterpret_cast<const uint32_t*>(S.offsets[s]);
    const uint32_t a = __ldg(off + key), b = __ldg(off + key + 1);
    const long long n = static_cast<long long>(b) - a;
    lo[k] = a;
    start[k] = (n > cutoff || n <= 0) ? 0 : static_cast<int>(n);
  }
  __syncthreads();
  int total;
  {
    int b, e, sum = 0;
    chunk(K, &b, &e);
    for (int k = b; k < e; ++k) sum += start[k];
    int excl = block_excl_scan(sum, wsum, &total);
    for (int k = b; k < e; ++k) {
      const int t = start[k];
      start[k] = excl;
      excl += t;
    }
    if (tid == 0) start[K] = total;
  }
  __syncthreads();
  if (total > cap) {
    if (tid == 0) {
      meta[1 + ow] = 0;
      meta[1 + n_owners + ow] = -1;
    }
    return;
  }

  // the postings gather: posting j of list k, start[k] <= j < start[k+1]
  for (int j = tid; j < total; j += THREADS) {
    int a = 0, b = K;
    while (b - a > 1) {
      const int m = (a + b) >> 1;
      if (start[m] <= j) a = m;
      else b = m;
    }
    int s = 0;
    while (a >= kbase[s + 1]) ++s;
    const int i = a - kbase[s] + min_pos;
    const uint32_t* pos = reinterpret_cast<const uint32_t*>(S.positions[s]);
    const uint32_t x = __ldg(pos + lo[a] + (j - start[a]));
    keys[j] = static_cast<uint64_t>(x) << 32
              | static_cast<uint32_t>(s * L + i);
  }
  int P = 1;
  while (P < total) P <<= 1;
  for (int j = total + tid; j < P; j += THREADS) keys[j] = ~0ull;
  __syncthreads();

  // bitonic sort of keys[0, P)
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }

  // the region test and the ordered compaction
  const long long ov = min(overlap, 1 << rbits);
  const long long rmask = (1ll << rbits) - 1;
  auto survives = [&](int k) -> bool {
    if (!use_region) return true;
    const long long x = static_cast<long long>(keys[k] >> 32);
    const long long px =
        k > 0 ? static_cast<long long>(keys[k - 1] >> 32) : -1;
    const long long nx =
        k + 1 < total ? static_cast<long long>(keys[k + 1] >> 32)
                      : LLONG_MAX;
    const long long r = x >> rbits;
    if (px >= (r << rbits) || nx < ((r + 1) << rbits) + ov) return true;
    if ((x & rmask) < overlap && r > 0)
      return px >= ((r - 1) << rbits) || nx < (r << rbits) + ov;
    return false;
  };
  int b, e, cnt = 0, n_surv;
  chunk(total, &b, &e);
  for (int k = b; k < e; ++k) cnt += survives(k);
  const int excl = block_excl_scan(cnt, wsum, &n_surv);
  if (tid == 0) {
    s_base = atomicAdd(reinterpret_cast<unsigned long long*>(meta),
                       static_cast<unsigned long long>(n_surv));
    meta[1 + ow] = static_cast<long long>(s_base);
    meta[1 + n_owners + ow] = n_surv;
  }
  __syncthreads();
  if (s_base + n_surv > static_cast<unsigned long long>(surv_cap))
    return;  // past `surv`: the caller runs the batch again with more
  uint64_t* out = surv + s_base + excl;
  for (int k = b; k < e; ++k)
    if (survives(k)) *out++ = keys[k];
}

// Dynamic shared memory of a block: the postings, the lists' prefix sums
// and first offsets, the read.
long long smem_bytes(int K, int L, int cap) {
  return 8ll * cap + 4ll * (K + 1) + 4ll * K + L;
}

}  // namespace

// Filter 1's front half over n_owners rows of `codes` ([n_owners, L]
// uint8, codes & 3 taken), `seeds` the device Seeds, K the keys an owner
// (sum over seeds of max(0, L - span + 1 - min_pos)), `cap` the postings
// an owner may have (a power of two), lists longer than `cutoff` skipped.
// Writes meta [1 + 2 n_owners] int64 (zeroed by the caller): the
// survivors' total, each owner's offset into `surv`, each owner's count
// (-1: over cap). `surv` holds surv_cap uint64; where the total exceeds
// it, some owners' survivors were not written and the caller launches
// again with surv_cap = n_owners * cap (room for any batch). Returns a
// cudaError_t.
extern "C" int filter1_front_launch(const void* codes, const void* seeds,
                                    void* surv, void* meta,
                                    long long surv_cap, int n_owners,
                                    int L, int min_pos, int K, int cap,
                                    int cutoff, int region_bits,
                                    int region_overlap, int use_region,
                                    void* stream) {
  if (n_owners <= 0) return 0;
  if (L < 1 || K < 0 || cap < 1 || (cap & (cap - 1)) != 0
      || region_bits < 0 || region_bits > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(K, L, cap);
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem + static_cast<long long>(sizeof(Seeds)) + 256 > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(filter1_front_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  filter1_front_kernel<<<n_owners, THREADS, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const Seeds*>(seeds),
      static_cast<uint64_t*>(surv), static_cast<long long*>(meta), surv_cap,
      n_owners, L, min_pos, K, cap, cutoff, region_bits, region_overlap,
      use_region);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration for K keys an owner, reads of L and `cap`
// postings: banded::config's six values (an owner a block). Returns a
// cudaError_t, or NO_FIT (-1, no CUDA error's code) where the block's
// shared memory exceeds the card's opt-in limit.
extern "C" int filter1_front_config(int K, int L, int cap, void* out) {
  const long long smem = smem_bytes(K, L, cap);
  int optin = 0;
  cudaError_t e = banded::smem_optin(&optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem + static_cast<long long>(sizeof(Seeds)) + 256 > optin)
    return NO_FIT;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(filter1_front_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return banded::config(filter1_front_kernel, THREADS, THREADS,
                        static_cast<int>(smem), static_cast<int*>(out));
}
