// Hugepage-backed host allocations for the genome index arrays.
//
// The CSR offset tables (4^weight + 1 entries per seed) are accessed at
// one random position per read kmer; with 4KB pages every lookup is
// also a dTLB miss whose page walk misses cache. MADV_HUGEPAGE-backed
// buffers keep the whole table in a few hundred TLB entries. This is
// the analogue of the reference keeping its genomemap resident and
// pointer-stable in a POSIX shm segment (genome.c:290-667) — here the
// win is TLB locality rather than cross-process reuse.

#include <cstdint>
#include <sys/mman.h>

extern "C" {

// Returns a MADV_HUGEPAGE anonymous mapping of at least nbytes
// (rounded up to 2MB), or nullptr. Caller frees with hp_free(ptr,
// nbytes) using the same nbytes.
void* hp_alloc(int64_t nbytes) {
    if (nbytes <= 0) return nullptr;
    int64_t sz = (nbytes + (1 << 21) - 1) & ~(int64_t)((1 << 21) - 1);
    void* p = mmap(nullptr, (size_t)sz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    madvise(p, (size_t)sz, MADV_HUGEPAGE);
    return p;
}

int hp_free(void* p, int64_t nbytes) {
    if (p == nullptr) return 0;
    int64_t sz = (nbytes + (1 << 21) - 1) & ~(int64_t)((1 << 21) - 1);
    return munmap(p, (size_t)sz);
}

}  // extern "C"
