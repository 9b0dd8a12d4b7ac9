// Shared device code of the WTBC count descent, used by the wavelet_count
// kernel (wavelet_descent.cu), the beam loop (beam_step.cu) and the DRB
// walk (drb_walk.cu), and of the byte ranks used by byte_rank.cu,
// segment_tf.cu and wtbc_decode.cu.
//
// One count: occurrences of word-rank w in root range [lo, hi).  At each of
// the three levels an endpoint a maps to p = clamp(node_off + a, 0, length)
// and its rank is the byte's occurrences before p, minus the word's base
// rank; the count is the difference of the two endpoints' ranks at the
// word's leaf level (cw_len), the reference's three-level walk with a leaf
// select.  The two endpoints are independent chains: an endpoint's rank at
// level L depends only on its own rank at level L-1.  An empty level is one
// zero tile with zero counters; its clamped positions are 0, so it
// contributes 0.  Positions are int32: the index build keeps every
// position below 2**31.
//
// What bounds a count on the H100: memory latency.  Level 0 of an ALL-sized
// index is larger than the 50 MB L2, so a rank's tile reads often go to HBM,
// and a count is a chain of dependent ranks.  The rank primitive:
//
// * warp_rank_near (K1, K2, K5, drb_walk; wtbc_decode its rule for two
//   positions at once, segment_tf for a tile's bounds together): counts
//   from the nearer end of the tile.  With
//   valid = min(block, length - blk*block) the tile's logical bytes, a cut
//   past valid / 2 ranks as counts[blk + 1][byte] minus the suffix
//   [cut, valid) — the last tile is zero-padded and its counters leave the
//   padding out, so the suffix stops at valid.  It reads at most block / 2
//   bytes (plus the 16-byte alignment of the suffix), and each lane issues
//   all of its tile loads (four 16-byte loads at block 4096) together with
//   the counter cell before any compare, so a rank costs one memory round
//   trip.  warp_endpoint_rank runs one endpoint's three levels on one warp,
//   so a count is two warps side by side and three round trips in series.
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

__device__ __forceinline__ int clamp_pos(int off, int a, int length) {
  const long long p = (long long)off + (long long)a;
  return (int)(p < 0 ? 0 : (p > length ? length : p));
}

// The low k bytes of a 32-bit word as a mask (k clamped to [0, 4]).
__device__ __forceinline__ uint32_t low_bytes(int k) {
  return k <= 0 ? 0u : (k >= 4 ? 0xffffffffu : (1u << (8 * k)) - 1u);
}

// Occurrences of the pattern's byte among bytes [lo, hi) of a 16-byte chunk
// (offsets relative to the chunk; any range, empty ones count 0).
__device__ __forceinline__ int count16(const uint4& v, uint32_t pat, int lo,
                                       int hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = low_bytes(hi - 4 * i) & ~low_bytes(lo - 4 * i);
    n += __popc(__vcmpeq4(w[i], pat) & m) >> 3;  // 0xff per equal byte
  }
  return n;
}

// 16-byte loads per lane issued at once: 4 x 32 x 16 = 2,048 bytes, the
// largest half tile at block 4096 (a larger block loops).
constexpr int kNearLoads = 4;

// Rank of `byte` at position p (already clamped to [0, length]) in one
// level, counted from the nearer end of p's tile; every lane returns it.
__device__ __forceinline__ int warp_rank_near(const Level& L, int block,
                                              int byte, int p) {
  const int lane = threadIdx.x & 31;
  const int blk = min(p / block, L.n_blocks - 1);
  const int start = blk * block;
  const int cut = p - start;
  const int valid = min(block, L.length - start);
  const bool back = cut > valid / 2;
  const int lo = back ? cut : 0, hi = back ? valid : cut;  // bytes to count
  const int cell = __ldg(L.counts + (size_t)(blk + back) * kCounterRow + byte);
  const uint8_t* tile = L.data + (size_t)start;
  const uint32_t pat = 0x01010101u * (uint32_t)byte;
  int cnt = 0;
  for (int c0 = lo & ~15; c0 < hi; c0 += kNearLoads * 32 * 16) {
    uint4 v[kNearLoads];
#pragma unroll
    for (int i = 0; i < kNearLoads; ++i) {  // every load before any compare
      const int c = c0 + (i * 32 + lane) * 16;
      v[i] = c < hi ? __ldg(reinterpret_cast<const uint4*>(tile + c))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kNearLoads; ++i) {
      const int c = c0 + (i * 32 + lane) * 16;
      cnt += count16(v[i], pat, lo - c, hi - c);
    }
  }
  cnt = warp_sum(cnt);
  return back ? cell - cnt : cell + cnt;
}

// A word's path through the levels: leaf level, and per level its byte,
// node offset and base rank.
struct WordPath {
  int len;
  int byte[kLevels], off[kLevels], base[kLevels];
};

__device__ __forceinline__ WordPath load_path(const WordTables& t, int w) {
  WordPath p;
  p.len = __ldg(t.cw_len + w);
#pragma unroll
  for (int L = 0; L < kLevels; ++L) {
    p.byte[L] = __ldg(t.cw + (size_t)w * kLevels + L);
    p.off[L] = __ldg(t.node_off + (size_t)w * kLevels + L);
    p.base[L] = __ldg(t.base_rank + (size_t)w * kLevels + L);
  }
  return p;
}

// One endpoint's chain: the word's rank at its leaf level for root position
// a; a count is leaf(hi) - leaf(lo).  0 when cw_len is outside [1, 3] (not
// a word of the index), so such a count is 0.  Every lane returns it.
__device__ __forceinline__ int warp_endpoint_rank(const Levels& lv,
                                                  const WordPath& w, int a) {
#pragma unroll
  for (int L = 0; L < kLevels; ++L) {
    const Level& lvl = lv.lv[L];
    a = warp_rank_near(lvl, lv.block, w.byte[L],
                       clamp_pos(w.off[L], a, lvl.length)) - w.base[L];
    if (w.len == L + 1) return a;
  }
  return 0;
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
