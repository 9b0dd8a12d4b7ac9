// Shared device code of the WTBC count descent, used by the wavelet_count
// kernel (wavelet_descent.cu) and the beam loop (beam_step.cu).
//
// One warp computes one count: occurrences of word-rank w in root range
// [lo, hi).  At each of the three levels both endpoints map to
// p = clamp(node_off + a, 0, length) and their rank is
//   counts[blk * 256 + byte] + #(tile[blk][0 : p - blk*block] == byte)
// with blk = min(p / block, n_blocks - 1), minus the word's base rank.  The
// clamp of blk makes p == length exact at a block edge (counter row plus one
// full-tile count).  An empty level is one zero tile with zero counters; its
// clamped positions are 0, so it contributes 0.  The descent stops at the
// word's leaf level (cw_len), which returns the same count as the reference's
// three-level walk with a leaf select.
//
// The in-tile count reads only the prefix [0, p - blk*block) of the tile:
// 16-byte loads per lane, a per-byte compare (__vcmpeq4) with popcount, then
// a warp reduction with __shfl_xor_sync.  Positions are int32: the index
// build keeps every position below 2**31.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wtbc {

constexpr int kLevels = 3;
constexpr int kCounterRow = 256;

struct Level {
  const uint8_t* data;   // (n_blocks * block,) bytes, 16-byte aligned
  const int32_t* counts; // (n_blocks + 1, 256) cumulative counters
  int n_blocks;
  int length;
};

struct Levels {
  Level lv[kLevels];
  int block;             // multiple of 16
};

struct WordTables {
  const uint8_t* cw;       // (V, 3) codeword bytes
  const int32_t* cw_len;   // (V,)
  const int32_t* node_off; // (V, 3)
  const int32_t* base_rank;// (V, 3)
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rank of `byte` at position p (already clamped to [0, length]) in one level;
// every lane of the warp returns the same value.
__device__ __forceinline__ int warp_rank(const Level& L, int block, int byte,
                                         int p) {
  const int lane = threadIdx.x & 31;
  const int blk = min(p / block, L.n_blocks - 1);
  const int cut = p - blk * block;                 // bytes of the tile to count
  const uint8_t* tile = L.data + (size_t)blk * block;
  const uint32_t pat = 0x01010101u * (uint32_t)byte;
  int cnt = 0;
  for (int c = lane * 16; c < cut; c += 32 * 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int rem = cut - c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int valid = rem - 4 * i;               // bytes of word i to count
      if (valid > 0) {
        uint32_t eq = __vcmpeq4(w[i], pat);        // 0xff per equal byte
        if (valid < 4) eq &= (1u << (8 * valid)) - 1u;
        cnt += __popc(eq) >> 3;
      }
    }
  }
  cnt = warp_sum(cnt);
  return __ldg(L.counts + (size_t)blk * kCounterRow + byte) + cnt;
}

__device__ __forceinline__ int clamp_pos(int off, int a, int length) {
  const long long p = (long long)off + (long long)a;
  return (int)(p < 0 ? 0 : (p > length ? length : p));
}

// Occurrences of word-rank w in root range [lo, hi); all lanes return it.
__device__ __forceinline__ int warp_count_range(const Levels& lv,
                                                const WordTables& t, int w,
                                                int lo, int hi) {
  const int len = __ldg(t.cw_len + w);
  int a = lo, b = hi;
#pragma unroll
  for (int L = 0; L < kLevels; ++L) {
    const Level& lvl = lv.lv[L];
    const int byte = __ldg(t.cw + (size_t)w * kLevels + L);
    const int off = __ldg(t.node_off + (size_t)w * kLevels + L);
    const int base = __ldg(t.base_rank + (size_t)w * kLevels + L);
    const int ra = warp_rank(lvl, lv.block, byte,
                             clamp_pos(off, a, lvl.length)) - base;
    const int rb = warp_rank(lvl, lv.block, byte,
                             clamp_pos(off, b, lvl.length)) - base;
    if (len == L + 1) return rb - ra;
    a = ra;
    b = rb;
  }
  return 0;  // cw_len outside [1, 3]: not a word of the index
}

inline Levels make_levels(const void* d0, const void* c0, int nb0, int len0,
                          const void* d1, const void* c1, int nb1, int len1,
                          const void* d2, const void* c2, int nb2, int len2,
                          int block) {
  Levels lv;
  lv.lv[0] = {static_cast<const uint8_t*>(d0), static_cast<const int32_t*>(c0),
              nb0, len0};
  lv.lv[1] = {static_cast<const uint8_t*>(d1), static_cast<const int32_t*>(c1),
              nb1, len1};
  lv.lv[2] = {static_cast<const uint8_t*>(d2), static_cast<const int32_t*>(c2),
              nb2, len2};
  lv.block = block;
  return lv;
}

inline WordTables make_tables(const void* cw, const void* cw_len,
                              const void* node_off, const void* base_rank) {
  return {static_cast<const uint8_t*>(cw), static_cast<const int32_t*>(cw_len),
          static_cast<const int32_t*>(node_off),
          static_cast<const int32_t*>(base_rank)};
}

}  // namespace wtbc
