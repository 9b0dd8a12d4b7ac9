// wavelet_count: fused 3-level WTBC count descent for a batch of triples.
//
// Replaces the Pallas kernel src/repro/kernels/wavelet_descent.py
// (_kernel_tpu, the manual-DMA TPU lowering, and _kernel_gpu, its pl.load
// twin, both around _descent_levels): for M (word, lo, hi) triples, the
// word's occurrences in root range [lo, hi).
//
// What bounds it on the H100: memory latency, not bandwidth or arithmetic.
// Each level's two tile positions depend on the previous level's ranks, so a
// triple is a chain of up to three dependent gathers (counter cell + tile
// prefix), and the bytes it needs are small (at most 3 x 2 x block prefix
// bytes plus six 4-byte counter cells).  The TPU kernel DMAs whole tiles and
// counter rows into VMEM; here a warp reads only the counter cell and the
// tile prefix it needs, 16 bytes per lane per load, so the latency is hidden
// by keeping many triples in flight: one warp per triple, 8 warps per block,
// M / 8 blocks across the 132 SMs.
//
// Layout contract (checked by the Python wrapper): level data contiguous,
// 16-byte aligned, n_blocks * block bytes with block a multiple of 16;
// counters (n_blocks + 1, 256) int32; cw (V, 3) uint8 read as bytes (not
// widened); node_off / base_rank (V, 3) int32; words / los / his (M,) int32.
#include "wtbc_descent.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wavelet_count_kernel(wtbc::Levels lv, wtbc::WordTables t,
                     const int32_t* __restrict__ words,
                     const int32_t* __restrict__ los,
                     const int32_t* __restrict__ his,
                     int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // uniform across the warp
  const int c = wtbc::warp_count_range(lv, t, __ldg(words + i), __ldg(los + i),
                                       __ldg(his + i));
  if ((threadIdx.x & 31) == 0) out[i] = c;
}

}  // namespace

extern "C" int wavelet_count(const void* d0, const void* c0, int nb0, int len0,
                             const void* d1, const void* c1, int nb1, int len1,
                             const void* d2, const void* c2, int nb2, int len2,
                             int block, const void* cw, const void* cw_len,
                             const void* node_off, const void* base_rank,
                             const void* words, const void* los,
                             const void* his, void* out, int m,
                             void* stream) {
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wavelet_count_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(los), static_cast<const int32_t*>(his),
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavelet_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
