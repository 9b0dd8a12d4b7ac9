// wtbc_decode: the word ranks at M root positions, every level of the
// WTBC's (s,c)-DC descent in one launch.
//
// Redesigns K5 (src/repro/kernels/byte_rank.py, _kernel: the rank of a
// byte over one counter-accelerated bytemap) for the H100 on the path that
// spends it: decode_at (core/wtbc.py) made one K5 launch per level for the
// 2 * M ranks of that level, with a handful of plain PyTorch gathers and
// selects between the levels.  Here one warp per position runs the whole
// descent (kernels/wtbc_decode.py: decode_at_ref is the plain loop, which
// this equals bit for bit).  Per level:
//   * the node offset offsets[L][prefix] (prefix: the continuer bytes read
//     so far);
//   * the byte at off + p (clamped into the level);
//   * a stopper byte ends the word: its rank is x * s + b + (the first rank
//     of the words of L + 1 bytes), and the warp stops;
//   * a continuer: the byte's ranks at off + p and at off, each counted from
//     the nearer end of its tile (wtbc_descent.cuh: warp_rank_near's rule)
//     with both ranks' loads and counter cells in flight together; their
//     difference is the position in the child node.
//
// What bounds it on the H100: latency.  A position is a chain of three
// dependent round trips per level (the offset, the byte, the ranks); the
// bytes it needs are a few counter cells and at most half a tile per rank.
// Many positions are in flight at once: 8 warps per block, M / 8 blocks.
//
// Layout contract (checked by the Python wrapper): levels as for
// wavelet_count; offsets (c**L + 1,) int32 per level; pos and out (M,)
// int32.
#include "wtbc_descent.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

struct Offsets {
  const int32_t* o[wtbc::kLevels];
};

// What a rank counted from the nearer end of its tile reads: the counter
// cell at that end and the tile's bytes [lo, hi) (warp_rank_near's rule).
struct NearSpan {
  int cell;
  const uint8_t* tile;
  int lo, hi;
  bool back;
};

__device__ __forceinline__ NearSpan near_span(const wtbc::Level& L, int block,
                                              int byte, int p) {
  const int blk = min(p / block, L.n_blocks - 1);
  const int start = blk * block;
  const int cut = p - start;
  const int valid = min(block, L.length - start);
  NearSpan s;
  s.back = cut > valid / 2;
  s.lo = s.back ? cut : 0;
  s.hi = s.back ? valid : cut;
  s.cell = __ldg(L.counts + (size_t)(blk + s.back) * wtbc::kCounterRow + byte);
  s.tile = L.data + (size_t)start;
  return s;
}

// The ranks of `byte` at positions pa and pb (clamped to [0, length]) of
// one level, every tile load of both issued before any compare; every
// lane returns them.
__device__ __forceinline__ void warp_rank_near_pair(const wtbc::Level& L,
                                                    int block, int byte,
                                                    int pa, int pb, int& ra,
                                                    int& rb) {
  const int lane = threadIdx.x & 31;
  const NearSpan a = near_span(L, block, byte, pa);
  const NearSpan b = near_span(L, block, byte, pb);
  const uint32_t pat = 0x01010101u * (uint32_t)byte;
  constexpr int kStep = wtbc::kNearLoads * 32 * 16;
  int ca = 0, cb = 0;
  for (int s = 0; (a.lo & ~15) + s < a.hi || (b.lo & ~15) + s < b.hi;
       s += kStep) {
    uint4 va[wtbc::kNearLoads], vb[wtbc::kNearLoads];
#pragma unroll
    for (int i = 0; i < wtbc::kNearLoads; ++i) {
      const int c = (i * 32 + lane) * 16 + s;
      const int x = (a.lo & ~15) + c, y = (b.lo & ~15) + c;
      va[i] = x < a.hi ? __ldg(reinterpret_cast<const uint4*>(a.tile + x))
                       : make_uint4(0u, 0u, 0u, 0u);
      vb[i] = y < b.hi ? __ldg(reinterpret_cast<const uint4*>(b.tile + y))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < wtbc::kNearLoads; ++i) {
      const int c = (i * 32 + lane) * 16 + s;
      const int x = (a.lo & ~15) + c, y = (b.lo & ~15) + c;
      ca += wtbc::count16(va[i], pat, a.lo - x, a.hi - x);
      cb += wtbc::count16(vb[i], pat, b.lo - y, b.hi - y);
    }
  }
  ca = wtbc::warp_sum(ca);
  cb = wtbc::warp_sum(cb);
  ra = a.back ? a.cell - ca : a.cell + ca;
  rb = b.back ? b.cell - cb : b.cell + cb;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wtbc_decode_kernel(wtbc::Levels lv, Offsets offs, int s, int c,
                   const int32_t* __restrict__ pos, int32_t* __restrict__ out,
                   int m) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // uniform across the warp
  int p = __ldg(pos + i);
  int prefix = 0, x = 0, rank = 0;
  long long base_k = 0, width = s;  // first rank of the words of L + 1 bytes
#pragma unroll
  for (int L = 0; L < wtbc::kLevels; ++L) {
    const wtbc::Level& lvl = lv.lv[L];
    const int off = __ldg(offs.o[L] + prefix);
    const int at = min(max(off + p, 0), max(lvl.length - 1, 0));
    const int b = __ldg(lvl.data + at);
    if (b < s) {  // a stopper: the word ends here (uniform across the warp)
      rank = x * s + b + (int)base_k;
      break;
    }
    int r1, r0;
    warp_rank_near_pair(lvl, lv.block, b,
                        wtbc::clamp_pos(off, p, lvl.length),
                        wtbc::clamp_pos(off, 0, lvl.length), r1, r0);
    p = r1 - r0;
    prefix = prefix * c + (b - s);
    x = x * c + (b - s);
    base_k += width;
    width *= c;
  }
  if ((threadIdx.x & 31) == 0) out[i] = rank;
}

}  // namespace

extern "C" int wtbc_decode(const void* d0, const void* c0, int nb0, int len0,
                           const void* d1, const void* c1, int nb1, int len1,
                           const void* d2, const void* c2, int nb2, int len2,
                           int block, const void* off0, const void* off1,
                           const void* off2, int s, int c, const void* pos,
                           void* out, int m, void* stream) {
  if (m < 1 || s < 1 || c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const Offsets offs = {{static_cast<const int32_t*>(off0),
                         static_cast<const int32_t*>(off1),
                         static_cast<const int32_t*>(off2)}};
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wtbc_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lv, offs, s, c, static_cast<const int32_t*>(pos),
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wtbc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
