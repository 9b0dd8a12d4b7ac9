// segment_tf: term frequency of one byte in each span of sorted bounds.
//
// Replaces the Pallas kernel src/repro/kernels/segment_tf.py (_kernel): for
// D + 1 sorted bounds, tf[d] = rank(bounds[d+1]) - rank(bounds[d]) of one
// byte.  The TPU kernel ranks every bound in its own grid step and lets the
// pipeline skip the DMA of a tile it already holds; the wrapper differences
// the ranks outside the kernel.
//
// What bounds it on the H100: bytes.  The work needs, per tile that holds
// bounds, the nearer end of the tile for each of them (the prefix [0, cut)
// against the tile's counter row, or the suffix [cut, valid) against the
// next row; valid = the tile's logical bytes), one counter cell per bound,
// the bounds and the spans' tf.  The design reads each of those once:
//
// * A thread block owns kBounds consecutive bounds (kSpans spans); the
//   next block starts at this block's last bound, so each span's two ends
//   lie in one block and tf is differenced in shared memory: one launch, no
//   rank array in device memory.  The bound two blocks share is ranked by
//   both (one bound in kSpans), as a counter cell plus an in-tile count.
// * Bounds of one tile that follow each other form a group (sorted bounds:
//   one group per tile the block touches).  One warp takes a group, reads
//   the 16-byte chunks of the tile that its bounds need from their nearer
//   ends — [0, front) for the cuts up to valid / 2 and [back, valid) for
//   the others, where front is the largest such cut and back the smallest
//   — with every load of a 4 KB window in flight at once.  Chunks neither
//   end needs are skipped: they would add equally to the two terms of a
//   suffix count.  Each bound's rank is its counter cell plus or minus a
//   count over the chunks read: every bound is ranked once, every chunk
//   read once.
// * Counting is a zero-byte test on each word xor the pattern (five
//   operations a word).  Lane l sums the counts of chunks 8l .. 8l + 7
//   (staged in shared memory) and one warp scan turns the sums into
//   per-chunk prefixes; a bound then adds its partial chunk (reloaded from
//   L1).
// * A block's busiest warp sets its time.  At ALL/4 a block of 384 bounds
//   touches 60 tiles on average and 66 at most, so 16 warps take at most 5
//   each in turn, and the 226 blocks (two per SM) are all resident at once.
//   What the card then spends is throughput on these scattered 1-2 KB
//   reads: prefetching a warp's next tile into L2, or staging tiles through
//   a cp.async double buffer, measured slower on the H100.
//
// Unsorted bounds give runs of one tile as groups, and the same ranks.
//
// Layout contract (checked by the Python wrapper): as byte_rank.cu; bounds
// (D + 1,) int32, D >= 1.
#include "wtbc_descent.cuh"

namespace {

constexpr int kBounds = 384;             // bounds per block
constexpr int kSpans = kBounds - 1;      // spans per block
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRounds = 8;               // 16-byte loads per lane per window
constexpr int kWindowChunks = kRounds * 32;
constexpr int kWindow = kWindowChunks * 16;  // bytes of a tile per window
constexpr unsigned kFull = 0xffffffffu;

// Bytes of w equal to the pattern's, as one set bit each (0x80 of a byte):
// a zero byte of w ^ pat is the only one whose low seven bits plus 0x7f do
// not carry into its high bit, and whose high bit is clear.
__device__ __forceinline__ uint32_t eq_bits(uint32_t w, uint32_t pat) {
  const uint32_t x = w ^ pat;
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// Occurrences among the first n bytes of a 16-byte chunk (n >= 0).
__device__ __forceinline__ int count_head(const uint4& v, uint32_t pat,
                                          int n) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  int c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c += __popc(eq_bits(w[i], pat) & wtbc::low_bytes(n - 4 * i));
  return c;
}

__device__ __forceinline__ int count_full(const uint4& v, uint32_t pat) {
  return __popc(eq_bits(v.x, pat)) + __popc(eq_bits(v.y, pat)) +
         __popc(eq_bits(v.z, pat)) + __popc(eq_bits(v.w, pat));
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// A group: the bounds s_pos[i0, i1), all in tile blk, and their
// nearer-end extents: front = the largest cut counted from the start of
// the tile, back = the smallest counted from its end.
struct Group {
  int blk, i0, i1, start, valid, front, back;
};

// Group g's extents; run by one warp.
__device__ Group extents(int block, int length, const int* s_pos,
                         const int* s_tile, const int* s_group, int g) {
  const int lane = threadIdx.x & 31;
  Group G;
  G.i0 = s_group[g];
  G.i1 = s_group[g + 1];
  G.blk = s_tile[G.i0];
  G.start = G.blk * block;
  G.valid = min(block, length - G.start);
  const int half = G.valid / 2;
  int front = 0, back = G.valid;
  for (int i = G.i0 + lane; i < G.i1; i += 32) {
    const int cut = s_pos[i] - G.start;
    if (cut > half) back = min(back, cut); else front = max(front, cut);
  }
  G.front = __reduce_max_sync(kFull, front);
  G.back = __reduce_min_sync(kFull, back);
  return G;
}

// Ranks of `byte` at group G's bounds into s_rank; run by one warp.  pre:
// the warp's (kWindowChunks,) scratch.
__device__ void rank_group(const wtbc::Level& L, int byte, uint32_t pat,
                           const Group& G, const int* s_pos, int* s_rank,
                           int* pre) {
  const int lane = threadIdx.x & 31;
  const int valid = G.valid, half = valid / 2;
  const uint8_t* tile = L.data + (size_t)G.start;

  // the first 32 bounds' counter cells, loaded before the tile
  int cell0 = 0;
  if (G.i0 + lane < G.i1) {
    const int cut = s_pos[G.i0 + lane] - G.start;
    cell0 = __ldg(L.counts + (size_t)(G.blk + (cut > half)) *
                                 wtbc::kCounterRow + byte);
  }

  // count[0, x) over the chunks read, per window of the tile
  int carry = 0;
  for (int s = 0; s < valid; s += kWindow) {
    uint4 v[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {      // every load before any count
      const int c = s + (r * 32 + lane) * 16;
      const bool need = c < valid && (c < G.front || c + 16 > G.back);
      v[r] = need ? __ldg(reinterpret_cast<const uint4*>(tile + c))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {      // per chunk, in chunk order
      const int c = s + (r * 32 + lane) * 16;
      const bool need = c < valid && (c < G.front || c + 16 > G.back);
      pre[r * 32 + lane] = !need ? 0
          : valid - c >= 16 ? count_full(v[r], pat)
                            : count_head(v[r], pat, valid - c);
    }
    __syncwarp();
    // exclusive prefix in chunk order: lane l sums chunks 8l .. 8l + 7
    int4* pre4 = reinterpret_cast<int4*>(pre);
    const int4 a = pre4[2 * lane], b = pre4[2 * lane + 1];
    const int sa = a.x + a.y + a.z + a.w;
    const int tot = sa + b.x + b.y + b.z + b.w;
    const int inc = warp_inclusive_scan(tot);
    const int base = carry + inc - tot;
    pre4[2 * lane] = make_int4(base, base + a.x, base + a.x + a.y,
                               base + a.x + a.y + a.z);
    pre4[2 * lane + 1] = make_int4(base + sa, base + sa + b.x,
                                   base + sa + b.x + b.y,
                                   base + sa + b.x + b.y + b.z);
    __syncwarp();
    for (int i = G.i0 + lane; i < G.i1; i += 32) {
      const int x = s_pos[i] - G.start;
      if (x >= s && x < s + kWindow) {
        const int j = (x - s) >> 4, rem = x & 15;
        int cx = pre[j];
        if (rem)
          cx += count_head(
              __ldg(reinterpret_cast<const uint4*>(tile + s + 16 * j)), pat,
              rem);
        s_rank[i] = cx;
      }
    }
    carry += __shfl_sync(kFull, inc, 31);
    __syncwarp();                              // before pre is rewritten
  }

  // a cut no window holds is valid itself (a whole number of windows)
  const bool whole = (valid % kWindow) == 0;
  for (int i = G.i0 + lane; i < G.i1; i += 32) {
    const int x = s_pos[i] - G.start;
    const int cx = (whole && x == valid) ? carry : s_rank[i];
    const bool from_back = x > half;
    const int cell = i - G.i0 < 32
        ? cell0
        : __ldg(L.counts + (size_t)(G.blk + from_back) * wtbc::kCounterRow +
                byte);
    s_rank[i] = from_back ? cell - (carry - cx) : cell + cx;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_tf_kernel(wtbc::Level lv, int block, int byte,
                  const int32_t* __restrict__ bounds,
                  int32_t* __restrict__ out, int d) {
  __shared__ int s_pos[kBounds], s_tile[kBounds], s_rank[kBounds];
  __shared__ int s_group[kBounds + 1], s_warp[kWarps];
  __shared__ __align__(16) int s_pre[kWarps][kWindowChunks];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d0 = blockIdx.x * kSpans;
  const int nb = min(kBounds, d + 1 - d0);    // bounds of this block

  int tile = -1;
  if (t < nb) {
    const int p = wtbc::clamp_pos(0, __ldg(bounds + d0 + t), lv.length);
    tile = min(p / block, lv.n_blocks - 1);
    s_pos[t] = p;
  }
  if (t < kBounds) s_tile[t] = tile;
  __syncthreads();
  // group starts: where the tile changes, compacted in order
  const bool first = t < nb && (t == 0 || s_tile[t - 1] != tile);
  const unsigned m = __ballot_sync(kFull, first);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int base = 0, n_groups = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_warp[w] : 0;
    n_groups += s_warp[w];
  }
  if (first) s_group[base + __popc(m & ((1u << lane) - 1u))] = t;
  if (t == 0) s_group[n_groups] = nb;
  __syncthreads();

  const uint32_t pat = 0x01010101u * (uint32_t)byte;
  for (int g = warp; g < n_groups; g += kWarps)
    rank_group(lv, byte, pat,
               extents(block, lv.length, s_pos, s_tile, s_group, g), s_pos,
               s_rank, s_pre[warp]);
  __syncthreads();
  if (t < nb - 1) out[d0 + t] = s_rank[t + 1] - s_rank[t];
}

}  // namespace

extern "C" int segment_tf(const void* data, const void* counts, int n_blocks,
                          int length, int block, int byte, const void* bounds,
                          void* out, int d, void* stream) {
  const wtbc::Level lv = {static_cast<const uint8_t*>(data),
                          static_cast<const int32_t*>(counts), n_blocks,
                          length};
  const int blocks = (d + kSpans - 1) / kSpans;
  segment_tf_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lv, block, byte, static_cast<const int32_t*>(bounds),
      static_cast<int32_t*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_tf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
