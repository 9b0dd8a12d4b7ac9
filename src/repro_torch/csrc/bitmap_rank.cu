// bitmap_rank1: batched rank1 over packed tf bitmaps (WTBC-DRB).
//
// Replaces the Pallas kernel src/repro/kernels/bitmap_rank.py (_kernel): for
// M positions, the set bits among the first pos bits of an LSB-first bit
// vector: counts[blk] + sum over the block's 32 uint32 words of
// popcount(word & lowmask), blk = pos / 1024.
//
// What bounds it on the H100: memory latency.  A query reads one counter and
// one 128-byte block of words whose address depends on the query.  One warp
// per query, one lane per word: each lane loads its word (the warp's 32
// loads are one coalesced 128-byte request), masks it to the bits below pos
// with no 1u << 32 (undefined in C), counts with __popc, and the warp sums
// with a shuffle reduction (wtbc::warp_sum).  8 warps per block, M / 8
// blocks keep many queries in flight.
//
// Layout contract (checked by the Python wrapper): words (n_blocks * 32,)
// 32-bit patterns; counts (n_blocks + 1,) int32 cumulative; pos (M,) int32.
#include "wtbc_descent.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWordsPerBlock = 32;   // one counter per 1024 bits

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitmap_rank1_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ counts, int n_blocks,
                    int n_bits, const int32_t* __restrict__ pos,
                    int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int p = wtbc::clamp_pos(0, __ldg(pos + i), n_bits);
  // the clamp to the last block makes p == n_bits exact at a block edge
  const int blk = min(p / (kWordsPerBlock * 32), n_blocks - 1);
  const int n_valid = p - blk * (kWordsPerBlock * 32) - lane * 32;
  const uint32_t w = __ldg(words + (size_t)blk * kWordsPerBlock + lane);
  const uint32_t mask =
      n_valid >= 32 ? ~0u : (n_valid <= 0 ? 0u : (1u << n_valid) - 1u);
  const int c = wtbc::warp_sum(__popc(w & mask));
  if (lane == 0) out[i] = __ldg(counts + blk) + c;
}

}  // namespace

extern "C" int bitmap_rank1(const void* words, const void* counts,
                            int n_blocks, int n_bits, const void* pos,
                            void* out, int m, void* stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bitmap_rank1_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(counts),
      n_blocks, n_bits, static_cast<const int32_t*>(pos),
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitmap_rank1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
