// wavelet_count: fused 3-level WTBC count descent for a batch of triples.
//
// Replaces the Pallas kernel src/repro/kernels/wavelet_descent.py
// (_kernel_tpu, the manual-DMA TPU lowering, and _kernel_gpu, its pl.load
// twin, both around _descent_levels): for M (word, lo, hi) triples, the
// word's occurrences in root range [lo, hi).
//
// What bounds it on the H100: memory latency, not bandwidth or arithmetic.
// A triple's endpoints each walk a chain of up to three dependent ranks
// (counter cell + part of a tile), and the bytes it needs are small.  The
// TPU kernel DMAs whole tiles and counter rows into VMEM; here each
// (triple, endpoint) gets its own warp (wtbc_descent.cuh:
// warp_endpoint_rank), whose rank reads only the nearer end of the tile with
// all its loads in flight at once, so a triple costs three memory round
// trips in series instead of six ranks of several each.  The two warps of a
// triple sit in one block and combine rb - ra through shared memory; many
// triples stay in flight across the 132 SMs.
//
// Layout contract (checked by the Python wrapper): level data contiguous,
// 16-byte aligned, n_blocks * block bytes with block a multiple of 16;
// counters (n_blocks + 1, 256) int32; cw (V, 3) uint8 read as bytes (not
// widened); node_off / base_rank (V, 3) int32; words / los / his (M,) int32.
#include "wtbc_descent.cuh"

namespace {

constexpr int kTriplesPerBlock = 2;  // two warps per triple

__global__ void __launch_bounds__(kTriplesPerBlock * 64)
wavelet_count_kernel(wtbc::Levels lv, wtbc::WordTables t,
                     const int32_t* __restrict__ words,
                     const int32_t* __restrict__ los,
                     const int32_t* __restrict__ his,
                     int32_t* __restrict__ out, int m) {
  __shared__ int leaf[kTriplesPerBlock][2];
  const int warp = threadIdx.x >> 5;
  const int tri = warp >> 1, end = warp & 1;  // end 0: lo, 1: hi
  const int i = blockIdx.x * kTriplesPerBlock + tri;
  if (i < m) {  // uniform across the warp
    const wtbc::WordPath w = wtbc::load_path(t, __ldg(words + i));
    const int r = wtbc::warp_endpoint_rank(lv, w, __ldg((end ? his : los) + i));
    if ((threadIdx.x & 31) == 0) leaf[tri][end] = r;
  }
  __syncthreads();
  const int j = blockIdx.x * kTriplesPerBlock + threadIdx.x;
  if (threadIdx.x < kTriplesPerBlock && j < m)
    out[j] = leaf[threadIdx.x][1] - leaf[threadIdx.x][0];
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
  const int blocks = (m + kTriplesPerBlock - 1) / kTriplesPerBlock;
  wavelet_count_kernel<<<blocks, kTriplesPerBlock * 64, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(los), static_cast<const int32_t*>(his),
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavelet_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
