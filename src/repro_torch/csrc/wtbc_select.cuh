// Shared device code of the selects, used by the DRB `and` walk
// (drb_walk.cu) and the DRB bag-of-words query (drb_or.cu).
//
// * warp_lower_bound: a 32-ary search of a non-decreasing array, each round
//   one probe per lane with all of them in flight.
// * warp_select: the j-th occurrence of a byte in one WTBC level
//   (core/bytemap.py: select), the counter column searched by
//   warp_lower_bound, then one scan of the block in 512-byte warp loads.
// * warp_locate: the root position of a word's j-th occurrence
//   (core/wtbc.py: locate), one warp_select per level from the leaf up.
// * warp_rank1 / warp_select1: rank and select over the packed tf bitmaps
//   (core/bitvec.py), one lane per 32-bit word of a 1,024-bit block.
//
// What bounds them on the H100: latency.  A select is a chain of dependent
// memory round trips (the search's rounds, then the block), so every load
// a round needs is issued before any of them is used, and a block is read
// as K1's nearer-end rank reads a tile, neighbouring lanes on neighbouring
// 16-byte chunks (with each lane reading 128 contiguous bytes instead,
// every warp load touched 32 cache lines and a select took four times as
// long on the H100).
#pragma once

#include "wtbc_descent.cuh"

namespace wtbc {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScanLoads = 8;                      // 16-byte loads a lane issues
constexpr int kPassBytes = 32 * 16 * kScanLoads;   // 4,096: block 4096 in one
constexpr int kBitsPerBlock = 1024;  // bit vector: a counter per 32 words

// Number of i in [0, n) with a[i * stride] < target, a non-decreasing: a
// 32-ary search, each round one probe per lane with all of them in flight,
// a ballot picks the interval.  Every lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int32_t* a, int stride,
                                                int n, int target) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool t = i < hi && __ldg(a + (size_t)i * stride) < target;
    const int m = __popc(__ballot_sync(kFullMask, t));  // a prefix of the lanes
    if (m == 0) {
      hi = lo;
    } else {
      const int nlo = lo + (m - 1) * step + 1;
      hi = min(hi, lo + m * step);
      lo = nlo;
    }
  }
  return lo;
}

// Position of the j-th (1-based) occurrence of `byte` in one level, the
// level's length where there is none (core/bytemap.py: select).  The block
// is the last one with fewer than j occurrences before it.  Its logical
// bytes (padding left out: byte 0 is a real codeword byte) are read as
// K1's nearer-end rank reads a tile, neighbouring lanes on neighbouring
// 16-byte chunks and every load issued before any compare; eight warp sums
// find the 512-byte chunk that holds the occurrence, a prefix sum over the
// lanes the lane, and that lane the byte.  Every lane returns it.
__device__ __forceinline__ int warp_select(const Level& L, int block,
                                           int byte, int j) {
  const int lane = threadIdx.x & 31;
  const int32_t* col = L.counts + byte;
  const int total = __ldg(col + (size_t)L.n_blocks * kCounterRow);
  const int blk = warp_lower_bound(col, kCounterRow, L.n_blocks, j) - 1;
  if (j < 1 || j > total) return L.length;
  int need = j - __ldg(col + (size_t)blk * kCounterRow);
  const int start = blk * block;
  const int valid = min(block, L.length - start);
  const uint8_t* tile = L.data + (size_t)start;
  const uint32_t pat = 0x01010101u * (uint32_t)byte;
  for (int b0 = 0; b0 < valid; b0 += kPassBytes) {
    uint4 v[kScanLoads];
#pragma unroll
    for (int i = 0; i < kScanLoads; ++i) {  // every load before any compare
      const int c = b0 + (i * 32 + lane) * 16;
      v[i] = c < valid ? __ldg(reinterpret_cast<const uint4*>(tile + c))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    // the 512-byte chunk i that holds the occurrence, by its warp sums
    int cnt = 0, hit = -1, run = 0, chunk_before = 0;
    uint4 vh = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kScanLoads; ++i) {
      const int c = count16(v[i], pat, 0, valid - (b0 + (i * 32 + lane) * 16));
      const int sum = __reduce_add_sync(kFullMask, c);
      if (hit < 0 && run + sum >= need) {  // uniform across the warp
        hit = i;
        chunk_before = run;
        cnt = c;
        vh = v[i];
      }
      run += sum;
    }
    if (hit < 0) {
      need -= run;
      continue;
    }
    need -= chunk_before;
    int incl = cnt;  // the lanes' prefix sums within the chunk
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += x;
    }
    const int t = __ffs(__ballot_sync(kFullMask, incl >= need)) - 1;
    int at = -1;
    if (lane == t) {
      int rem = need - (incl - cnt);  // 1-based among this lane's matches
      const int c = b0 + (hit * 32 + lane) * 16;
      const uint32_t w[4] = {vh.x, vh.y, vh.z, vh.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t bits = __vcmpeq4(w[q], pat) & low_bytes(valid - (c + 4 * q)) &
                        0x80808080u;  // one bit per equal byte
        const int n = __popc(bits);
        if (at < 0) {
          if (rem <= n) {
            for (int r = 1; r < rem; ++r) bits &= bits - 1u;
            at = c + 4 * q + ((__ffs(bits) - 1) >> 3);
          } else {
            rem -= n;
          }
        }
      }
    }
    return start + __shfl_sync(kFullMask, at, t);
  }
  return L.length;  // not reached for j within the level's counts
}

// Root position of the j-th occurrence of a word (core/wtbc.py: locate):
// leaf level up to the root, one select per level.
__device__ __forceinline__ int warp_locate(const Levels& lv, const WordPath& w,
                                           int j) {
  int pos = 0;
#pragma unroll
  for (int L = kLevels - 1; L >= 0; --L) {
    if (L >= w.len) continue;  // uniform across the warp
    const int idx = w.base[L] + (L == w.len - 1 ? j : pos + 1);
    pos = warp_select(lv.lv[L], lv.block, w.byte[L], idx) - w.off[L];
  }
  return pos;
}

// Set bits among the first pos bits of the tf bitmaps (bitmap_rank.cu's
// rank, one warp, one lane per word); every lane returns it.
__device__ __forceinline__ int warp_rank1(const uint32_t* words,
                                          const int32_t* counts, int n_blocks,
                                          int n_bits, int pos) {
  const int lane = threadIdx.x & 31;
  const int p = clamp_pos(0, pos, n_bits);
  const int blk = min(p / kBitsPerBlock, n_blocks - 1);
  const int n_valid = p - blk * kBitsPerBlock - lane * 32;
  const int cell = __ldg(counts + blk);
  const uint32_t w = __ldg(words + (size_t)blk * 32 + lane);
  const uint32_t mask =
      n_valid >= 32 ? ~0u : (n_valid <= 0 ? 0u : (1u << n_valid) - 1u);
  return cell + warp_sum(__popc(w & mask));
}

// Bit index (0-based) of the r-th (1-based) set bit of w, r <= popc(w): a
// binary search over the popcounts of halves.
__device__ __forceinline__ int nth_set_bit(uint32_t w, int r) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const int c = __popc(w & ((1u << half) - 1u));
    if (r > c) {
      r -= c;
      pos += half;
      w >>= half;
    }
  }
  return pos;
}

// Position of the j-th (1-based) set bit of the tf bitmaps, n_bits where
// there is none (core/bitvec.py: select1).  The block is the last one of
// [blk_lo, blk_hi) with fewer than j ones before it (warp_lower_bound over
// the counters; a caller that knows the answer's range passes it, else
// [0, n_blocks)); a range of one block needs no search); then one lane per
// 32-bit word of the block: its popcount, a prefix sum over the lanes, and
// the bit inside the lane's word.  Every lane returns it.
__device__ __forceinline__ int warp_select1(const uint32_t* words,
                                            const int32_t* counts,
                                            int n_blocks, int n_bits, int j,
                                            int blk_lo, int blk_hi) {
  const int lane = threadIdx.x & 31;
  if (j < 1 || j > __ldg(counts + n_blocks)) return n_bits;
  const int blk =
      blk_hi - blk_lo == 1
          ? blk_lo
          : blk_lo + warp_lower_bound(counts + blk_lo, 1, blk_hi - blk_lo, j) -
                1;
  const int need = j - __ldg(counts + blk);
  const uint32_t w = __ldg(words + (size_t)blk * 32 + lane);
  const int cnt = __popc(w);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += x;
  }
  const int t = __ffs(__ballot_sync(kFullMask, incl >= need)) - 1;
  const int bit = lane == t ? nth_set_bit(w, need - (incl - cnt)) : 0;
  return (blk * 32 + t) * 32 + __shfl_sync(kFullMask, bit, t);
}

}  // namespace wtbc
