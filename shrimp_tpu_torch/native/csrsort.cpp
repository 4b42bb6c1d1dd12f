// Parallel counting-sort CSR build for the genome index.
//
// build_index's inverted-index construction sorts (key, position)
// pairs by key with ties in ascending position order.  numpy's stable
// argsort (mergesort) is O(n log n) and single-threaded — at hg-scale
// (billions of positions) it dominates the index build.  Keys are
// bounded by 4^weight (or 2^24 hashed), so a two-pass counting sort is
// O(n + K), stable by construction, and parallelizes cleanly:
//
//   pass 1: per-thread key histograms over position-ordered chunks
//   merge:  exclusive prefix sum -> per-(thread, key) write bases
//   pass 2: each thread scatters its chunk; per-key output stays in
//           ascending position order (chunks are position-ordered)
//
// Matches the reference's left-to-right append order (genome.c:1140-1166).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" int64_t csr_counting_sort(
    const uint32_t* keys, const uint32_t* pos, int64_t n, int64_t n_keys,
    int64_t* offsets /* [n_keys + 1] */, uint32_t* out_pos /* [n] */,
    int32_t nthreads) {
  if (n_keys <= 0)
    return -1;
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  // cap per-thread histogram memory at ~2 GB total
  int64_t max_t = ((int64_t)2 << 30) / ((int64_t)n_keys * 4);
  if (max_t < 1) max_t = 1;
  if (nthreads > max_t) nthreads = (int32_t)max_t;
  if (nthreads > n) nthreads = n > 0 ? (int32_t)n : 1;
  const int T = nthreads;
  const int64_t per = (n + T - 1) / T;

  std::vector<std::vector<uint32_t>> cnt(T);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++)
      ts.emplace_back([&, t]() {
        cnt[t].assign((size_t)n_keys, 0u);
        const int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        uint32_t* c = cnt[t].data();
        for (int64_t i = lo; i < hi; i++)
          c[keys[i]]++;
      });
    for (auto& th : ts) th.join();
  }

  // exclusive prefix over total counts + per-thread bases (in place)
  {
    std::vector<std::thread> ts;
    const int PT = T;  // parallelize the K-length pass too
    // stage 1: per-range partial totals so ranges can prefix independently
    std::vector<int64_t> range_total(PT, 0);
    const int64_t kper = (n_keys + PT - 1) / PT;
    for (int t = 0; t < PT; t++)
      ts.emplace_back([&, t]() {
        const int64_t klo = t * kper,
                      khi = klo + kper < n_keys ? klo + kper : n_keys;
        int64_t tot = 0;
        for (int64_t k = klo; k < khi; k++) {
          for (int tt = 0; tt < T; tt++) tot += cnt[tt][(size_t)k];
        }
        range_total[t] = tot;
      });
    for (auto& th : ts) th.join();
    ts.clear();
    std::vector<int64_t> range_base(PT, 0);
    for (int t = 1; t < PT; t++)
      range_base[t] = range_base[t - 1] + range_total[t - 1];
    for (int t = 0; t < PT; t++)
      ts.emplace_back([&, t]() {
        const int64_t klo = t * kper,
                      khi = klo + kper < n_keys ? klo + kper : n_keys;
        int64_t acc = range_base[t];
        for (int64_t k = klo; k < khi; k++) {
          offsets[k] = acc;
          for (int tt = 0; tt < T; tt++) {
            // thread tt writes key k's entries at acc .. acc+c-1;
            // store its base relative to offsets[k] (fits uint32:
            // positions are uint32 so any list length does too)
            uint32_t c = cnt[tt][(size_t)k];
            cnt[tt][(size_t)k] = (uint32_t)(acc - offsets[k]);
            acc += c;
          }
        }
      });
    for (auto& th : ts) th.join();
    offsets[n_keys] = n;
  }

  // pass 2: scatter (cnt[t][k] holds the thread's base offset relative
  // to offsets[k]; per-key cursor advances within the thread's range)
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++)
      ts.emplace_back([&, t]() {
        const int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        uint32_t* c = cnt[t].data();
        for (int64_t i = lo; i < hi; i++) {
          uint32_t k = keys[i];
          out_pos[offsets[k] + c[k]] = pos[i];
          c[k]++;
        }
      });
    for (auto& th : ts) th.join();
  }
  return 0;
}

// Threaded spaced-seed key computation: out[i] = OR_j (codes[i+off_j]&3)
// << 2j (sliding_mapidx, index/seeds.py) — the unhashed kmer_to_mapidx
// (gmapper.h:323-338) over every window start.
extern "C" int64_t spaced_keys(const uint8_t* codes, int64_t n,
                               const int32_t* offsets, int32_t n_off,
                               uint32_t* out, int32_t nthreads) {
  if (n <= 0) return 0;
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (nthreads > n) nthreads = (int32_t)n;
  const int64_t per = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++)
    ts.emplace_back([&, t]() {
      const int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
      for (int64_t i = lo; i < hi; i++) {
        uint32_t m = 0;
        for (int32_t j = 0; j < n_off; j++)
          m |= (uint32_t)(codes[i + offsets[j]] & 3) << (2 * j);
        out[i] = m;
      }
    });
  for (auto& th : ts) th.join();
  return 0;
}
