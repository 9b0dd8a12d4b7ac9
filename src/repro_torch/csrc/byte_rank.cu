// byte_rank: batched rank over one counter-accelerated bytemap.
//
// Replaces the Pallas kernel src/repro/kernels/byte_rank.py (_kernel): for M
// (byte, pos) queries, the occurrences of byte in data[0 : pos] as the
// counter cell of pos's block plus a masked compare over the tile prefix.
//
// What bounds it on the H100: memory latency.  A query is one counter cell
// and at most half a tile, a gather whose address comes from the query
// itself.  The TPU kernel DMAs the whole tile and counter row into VMEM per
// grid step; here one warp per query counts from the nearer end of the
// tile (wtbc::warp_rank_near, the rank K1 and K2 use: the prefix [0, cut)
// against the block's counter row, or the suffix [cut, valid) against the
// next one), every 16-byte load and the counter cell issued before any
// compare, and many queries stay in flight: 8 warps per block, M / 8
// blocks.  WTBC decoding no longer calls it: wtbc_decode.cu runs the whole
// descent; bytemap.rank still does.
//
// Layout contract (checked by the Python wrapper): data contiguous, 16-byte
// aligned, n_blocks * block bytes, block a multiple of 16; counts
// (n_blocks + 1, 256) int32; bytes / pos (M,) int32, bytes in [0, 256).
#include "wtbc_descent.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
byte_rank_kernel(wtbc::Level lv, int block, const int32_t* __restrict__ bytes,
                 const int32_t* __restrict__ pos, int32_t* __restrict__ out,
                 int m) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // uniform across the warp
  const int p = wtbc::clamp_pos(0, __ldg(pos + i), lv.length);
  const int r = wtbc::warp_rank_near(lv, block, __ldg(bytes + i), p);
  if ((threadIdx.x & 31) == 0) out[i] = r;
}

}  // namespace

extern "C" int byte_rank(const void* data, const void* counts, int n_blocks,
                         int length, int block, const void* bytes,
                         const void* pos, void* out, int m, void* stream) {
  const wtbc::Level lv = {static_cast<const uint8_t*>(data),
                          static_cast<const int32_t*>(counts), n_blocks,
                          length};
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  byte_rank_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      lv, block, static_cast<const int32_t*>(bytes),
      static_cast<const int32_t*>(pos), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* byte_rank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
