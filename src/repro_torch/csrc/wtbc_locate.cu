// wtbc_locate: the root positions of M (word, j) occurrences, every level
// of the WTBC's locate in one launch.
//
// It ports no TPU kernel: the reference's locate is plain jnp
// (src/repro/core/wtbc.py: locate), one select per level from the word's
// leaf up.  The port's plain version (kernels/wtbc_locate.py:
// wtbc_locate_ref) runs every level for every lane as batched tensor code,
// a binary search of the byte's counter column and a compare of a whole
// block per select.  The positional searches (core/positional.py) locate
// every occurrence of their anchor or query words, so the locate is their
// main work; here one warp per (word, j) runs the whole walk with
// wtbc_select.cuh's warp_locate (the DRB kernels' locate): per level a
// 32-ary warp search of the byte's counter column, then one scan of the
// block's logical bytes.  It equals the plain version bit for bit, also for
// j outside 1..occ[w], where each level's select saturates to its level's
// length exactly as the plain select does.
//
// What bounds it on the H100: latency.  A locate is a chain of dependent
// memory round trips (per level the search's rounds, then the block), so
// many lanes must be in flight: 8 warps per block, M / 8 blocks.
//
// Layout contract (checked by the Python wrapper): levels and word tables as
// for wavelet_count; words, js and out (M,) int32, words in [0, V).
#include "wtbc_select.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wtbc_locate_kernel(wtbc::Levels lv, wtbc::WordTables t,
                   const int32_t* __restrict__ words,
                   const int32_t* __restrict__ js, int32_t* __restrict__ out,
                   int m) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // uniform across the warp
  const wtbc::WordPath path = wtbc::load_path(t, __ldg(words + i));
  const int pos = wtbc::warp_locate(lv, path, __ldg(js + i));
  if ((threadIdx.x & 31) == 0) out[i] = pos;
}

}  // namespace

extern "C" int wtbc_locate(const void* d0, const void* c0, int nb0, int len0,
                           const void* d1, const void* c1, int nb1, int len1,
                           const void* d2, const void* c2, int nb2, int len2,
                           int block, const void* cw, const void* cw_len,
                           const void* node_off, const void* base_rank,
                           const void* words, const void* js, void* out, int m,
                           void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wtbc_locate_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(js), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wtbc_locate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
