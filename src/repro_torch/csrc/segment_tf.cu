// segment_tf: term frequency of one byte in each span of sorted bounds.
//
// Replaces the Pallas kernel src/repro/kernels/segment_tf.py (_kernel): for
// D + 1 sorted bounds, tf[d] = rank(bounds[d+1]) - rank(bounds[d]) of one
// byte.  The TPU kernel ranks every bound in its own grid step and lets the
// pipeline skip the DMA of a tile it already holds; the wrapper differences
// the ranks outside the kernel.
//
// What bounds it on the H100: bytes.  Over all D spans the kernel must read
// the tile prefixes its bounds cut (about the whole level when the spans
// cover it) plus one counter cell per bound.  One warp per span ranks both
// of its ends (wtbc::warp_rank: counter cell + 16-byte loads of the tile
// prefix) and writes the difference, so there is one launch and no rank
// array in device memory.  Sorted bounds make neighbouring warps read the
// same tile, so the second read of a tile is served by L2 (this card's
// counterpart of the TPU pipeline skipping a revisited block).
//
// Layout contract (checked by the Python wrapper): as byte_rank.cu; bounds
// (D + 1,) int32, sorted.
#include "wtbc_descent.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_tf_kernel(wtbc::Level lv, int block, int byte,
                  const int32_t* __restrict__ bounds,
                  int32_t* __restrict__ out, int d) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= d) return;  // uniform across the warp
  const int lo = wtbc::clamp_pos(0, __ldg(bounds + i), lv.length);
  const int hi = wtbc::clamp_pos(0, __ldg(bounds + i + 1), lv.length);
  const int r = wtbc::warp_rank(lv, block, byte, hi) -
                wtbc::warp_rank(lv, block, byte, lo);
  if ((threadIdx.x & 31) == 0) out[i] = r;
}

}  // namespace

extern "C" int segment_tf(const void* data, const void* counts, int n_blocks,
                          int length, int block, int byte, const void* bounds,
                          void* out, int d, void* stream) {
  const wtbc::Level lv = {static_cast<const uint8_t*>(data),
                          static_cast<const int32_t*>(counts), n_blocks,
                          length};
  const int blocks = (d + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_tf_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lv, block, byte, static_cast<const int32_t*>(bounds),
      static_cast<int32_t*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_tf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
