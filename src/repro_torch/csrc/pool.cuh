// Shared device code of the pool frontiers (core/heap.py's Pool layout),
// used by the mega core's loop (beam_step.cu: beam_loop) and the heap core's
// loop (heap_loop.cu): the per-chunk summaries that let one warp pop the
// lex-greatest slot of a row and find its lowest free slots without scanning
// the row's slots in device memory.
//
// Total order of keys: score desc, d0 asc, d1 desc (first slot index on a
// full tie), the order of core/heap.py's lex_argmax.
//
// Per-chunk summaries.  A row's slots fall in chunks of 256; a chunk's
// summary is its lex-greatest live key (s, d0, d1, idx), its two lowest free
// slots below cap and a bit per slot (set: free), 56 bytes a chunk.  They
// are kept in dynamic shared memory, sized from cap at launch, while they
// fit one block's opt-in (about 1 M slots on an H100 for beam_loop); past
// it, in a per-row region of a global scratch (the same layout; it stays in
// L2 and the row's block alone touches it).  A kernel body is instantiated
// for both places, so both keep every leaf bitwise.  A per-row high-water
// mark hw (every slot >= hw is free) bounds a pop to the chunks that hold
// slots [0, hw + 1], so the lowest two free slots — the holes below hw, then
// hw, hw + 1 — are exact.
//
// A pop frees its slot (score -inf) and summarises the slot's chunk again
// (warp_summarise); an insert updates its chunk's summary in place
// (note_insert: the new key against the best, its bit out of the free mask)
// and then the chunk's two lowest free slots from the mask (mask_low2).
//
// heap_loop pops P slots at once with the whole block: block_select, a
// radix select over the keys' 128 bits (Key4), picks the P best chunk
// summaries and then the P best slots among those chunks; beam_loop pops
// one slot a trip on one warp (warp_best).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wtbc_descent.cuh"

namespace pool {

constexpr int kChunk = 256;               // slots per summary
constexpr int kSlotsPerLane = kChunk / 32;
constexpr int kMaskWords = kChunk / 32;
// s, d0, d1, idx, f1, f2 and the chunk's free-slot bit mask
constexpr int kSummaryInts = 6 + kMaskWords;
constexpr int kSummaryBytes = 4 * kSummaryInts;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  float s;
  int d0, d1, idx;  // idx < 0: no live slot seen
};

__device__ __forceinline__ bool precedes(const Key& a, const Key& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  if (a.s != b.s) return a.s > b.s;
  if (a.d0 != b.d0) return a.d0 < b.d0;
  if (a.d1 != b.d1) return a.d1 > b.d1;
  return a.idx < b.idx;
}

// (a1, a2) <- the two lowest of {a1, a2, b1, b2}; pairs ascending and
// disjoint, INT_MAX for "none".
__device__ __forceinline__ void merge_low2(int& a1, int& a2, int b1, int b2) {
  const int lo = min(a1, b1);
  const int hi = a1 < b1 ? min(a2, b1) : min(a1, b2);
  a1 = lo;
  a2 = hi;
}

__device__ __forceinline__ void warp_reduce_key(Key& best) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key other = {__shfl_xor_sync(kFull, best.s, o),
                       __shfl_xor_sync(kFull, best.d0, o),
                       __shfl_xor_sync(kFull, best.d1, o),
                       __shfl_xor_sync(kFull, best.idx, o)};
    if (precedes(other, best)) best = other;
  }
}

// All-lanes reduction of a key and a free pair across the warp.
__device__ __forceinline__ void warp_reduce(Key& best, int& f1, int& f2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key other = {__shfl_xor_sync(kFull, best.s, o),
                       __shfl_xor_sync(kFull, best.d0, o),
                       __shfl_xor_sync(kFull, best.d1, o),
                       __shfl_xor_sync(kFull, best.idx, o)};
    if (precedes(other, best)) best = other;
    merge_low2(f1, f2, __shfl_xor_sync(kFull, f1, o),
               __shfl_xor_sync(kFull, f2, o));
  }
}

// The chunk summaries, structure of arrays (in dynamic shared memory, or in
// the row's region of the global scratch): the best live key, the two
// lowest free slots, and a bit per slot (set: free).
struct Summaries {
  float* s;
  int *d0, *d1, *idx, *f1, *f2;
  uint32_t* free;  // kMaskWords per chunk
};

// The summaries laid out over kSummaryInts * n_chunks ints at dw.
__device__ __forceinline__ Summaries summaries_at(int* dw, int n_chunks) {
  return {reinterpret_cast<float*>(dw), dw + n_chunks, dw + 2 * n_chunks,
          dw + 3 * n_chunks, dw + 4 * n_chunks, dw + 5 * n_chunks,
          reinterpret_cast<uint32_t*>(dw + 6 * n_chunks)};
}

// The chunks that can hold a live slot or one of the two lowest free slots
// of a row whose high-water mark is hw.
__device__ __forceinline__ int active_chunks(int hw, int n_chunks) {
  return min(n_chunks, (hw + 1) / kChunk + 1);
}

// The lex-greatest live key over chunks [0, active) and the row's two
// lowest free slots; every lane returns them.
__device__ __forceinline__ void warp_best(const Summaries& sm, int active,
                                          Key& best, int& f1, int& f2) {
  best = {-CUDART_INF_F, 0, 0, -1};
  f1 = f2 = INT_MAX;
  for (int ch = threadIdx.x & 31; ch < active; ch += 32) {
    const Key c = {sm.s[ch], sm.d0[ch], sm.d1[ch], sm.idx[ch]};
    if (precedes(c, best)) best = c;
    merge_low2(f1, f2, sm.f1[ch], sm.f2[ch]);
  }
  warp_reduce(best, f1, f2);
}

// The two lowest free slots of chunk ch from its bit mask (INT_MAX for
// none); every lane returns them.
__device__ __forceinline__ void mask_low2(const Summaries& sm, int ch, int& f1,
                                          int& f2) {
  const int lane = threadIdx.x & 31;
  uint32_t w = lane < kMaskWords ? sm.free[ch * kMaskWords + lane] : 0u;
  f1 = f2 = INT_MAX;
  unsigned nz = __ballot_sync(kFull, w != 0u);
  if (!nz) return;
  int l = __ffs(nz) - 1;
  f1 = ch * kChunk + l * 32 + __ffs(__shfl_sync(kFull, w, l)) - 1;
  if (lane == l) w &= w - 1u;  // drop that bit
  nz = __ballot_sync(kFull, w != 0u);
  if (!nz) return;
  l = __ffs(nz) - 1;
  f2 = ch * kChunk + l * 32 + __ffs(__shfl_sync(kFull, w, l)) - 1;
}

// One warp summarises chunk ch: each lane issues its 8 slots' loads of the
// three arrays at once, then the warp reduces.  Lane 0 writes the summary
// and the free mask; every lane gets the chunk's live count and highest
// live slot.
__device__ __forceinline__ void warp_summarise(const Summaries& sm, int ch,
                                               const float* ps,
                                               const int32_t* p0,
                                               const int32_t* p1, int cap,
                                               int* live = nullptr,
                                               int* top = nullptr) {
  const int lane = threadIdx.x & 31;
  float s[kSlotsPerLane];
  int a[kSlotsPerLane], b[kSlotsPerLane];
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    const int i = ch * kChunk + j * 32 + lane;
    const bool in = i < cap;
    s[j] = in ? ps[i] : -CUDART_INF_F;
    a[j] = in ? p0[i] : 0;
    b[j] = in ? p1[i] : 0;
  }
  Key best = {-CUDART_INF_F, 0, 0, -1};
  int f1 = INT_MAX, f2 = INT_MAX, cnt = 0, hi = -1;
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {  // a lane's slots ascend in j
    const int i = ch * kChunk + j * 32 + lane;
    const unsigned fm = __ballot_sync(kFull, i < cap && !(s[j] > -CUDART_INF_F));
    if (lane == 0) sm.free[ch * kMaskWords + j] = fm;
    if (i >= cap) continue;
    if (s[j] > -CUDART_INF_F) {
      const Key c = {s[j], a[j], b[j], i};
      if (precedes(c, best)) best = c;
      ++cnt;
      hi = i;
    } else if (f1 == INT_MAX) {
      f1 = i;
    } else if (f2 == INT_MAX) {
      f2 = i;
    }
  }
  warp_reduce(best, f1, f2);
  if (lane == 0) {
    sm.s[ch] = best.s;
    sm.d0[ch] = best.d0;
    sm.d1[ch] = best.d1;
    sm.idx[ch] = best.idx;
    sm.f1[ch] = f1;
    sm.f2[ch] = f2;
  }
  if (live) *live = wtbc::warp_sum(cnt);
  if (top) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    *top = hi;
  }
}

// One thread: key (whose idx is its slot) inserted into its chunk's summary
// — the new key against the chunk's best, the slot's bit out of the free
// mask.  The chunk's free pair is left to mask_low2.
__device__ __forceinline__ void note_insert(const Summaries& sm,
                                            const Key& key) {
  const int ch = key.idx / kChunk;
  const Key cur = {sm.s[ch], sm.d0[ch], sm.d1[ch], sm.idx[ch]};
  if (precedes(key, cur)) {
    sm.s[ch] = key.s;
    sm.d0[ch] = key.d0;
    sm.d1[ch] = key.d1;
    sm.idx[ch] = key.idx;
  }
  sm.free[key.idx / 32] &= ~(1u << (key.idx & 31));
}

// The whole block (kWarps warps) summarises every chunk of the row, one
// warp per chunk; thread 0 then writes the row's high-water mark and live
// count.  The caller synchronises before reading them.
template <int kWarps>
__device__ __forceinline__ void block_summarise(const Summaries& sm,
                                                int n_chunks, const float* ps,
                                                const int32_t* p0,
                                                const int32_t* p1, int cap,
                                                int* warp_live, int* warp_top,
                                                int* hw, int* n_live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int live = 0, top = -1;
  for (int ch = warp; ch < n_chunks; ch += kWarps) {
    int c, h;
    warp_summarise(sm, ch, ps, p0, p1, cap, &c, &h);
    live += c;
    top = max(top, h);
  }
  if (lane == 0) {
    warp_live[warp] = live;
    warp_top[warp] = top;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int h = -1, c = 0;
    for (int w = 0; w < kWarps; ++w) {
      h = max(h, warp_top[w]);
      c += warp_live[w];
    }
    *hw = h + 1;
    *n_live = c;
  }
}

// ---- block-wide selection (heap_loop's pops) ----
//
// A key of the total order as four 32-bit words compared lexicographically,
// greater first: the score's order bits (-0 as +0), ~d0, d1, ~idx — so
// "greater" is precedes().
struct Key4 {
  uint32_t w[4];
};

__device__ __forceinline__ Key4 key4(float s, int d0, int d1, int idx) {
  uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return {{u, 0xffffffffu - static_cast<uint32_t>(d0),
           static_cast<uint32_t>(d1), 0xffffffffu - static_cast<uint32_t>(idx)}};
}

__device__ __forceinline__ bool key4_ge(const Key4& a, const Key4& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (a.w[i] != b.w[i]) return a.w[i] > b.w[i];
  return true;
}

// The scratch of block_select: two 256-bin histograms (one counted while
// the other is cleared), the scan's ints, and the keys of a small bucket.
struct SelectScratch {
  unsigned hist[2][256];
  int sc[12];
  int n_small;
  Key4 small[32];
  Key4 thr;
};

// Radix select over the valid keys get(i, key), i in [0, n): returns a
// threshold T such that the `want` greatest valid keys are exactly the
// valid keys >= T (every valid key when there are at most `want`).  Digits
// of 8 bits from the most significant; the select stops at the first digit
// whose bucket is taken whole, or once the bucket that holds the want-th
// key has at most 32 keys: those are gathered and ranked by one warp.
// Every thread of the block (kThreads >= 256) calls it; keys are distinct.
template <int kThreads, class Get>
__device__ Key4 block_select(Get get, int n, int want, SelectScratch& x) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Key4 pre = {{0u, 0u, 0u, 0u}};
  for (int b = tid; b < 256; b += kThreads) x.hist[0][b] = 0u;
  if (tid == 0) x.n_small = 0;
  __syncthreads();
  for (int j = 0; j < 16; ++j) {
    const int wi = j >> 2, sh = 24 - 8 * (j & 3);
    const uint32_t hm = sh == 24 ? 0u : ~0u << (sh + 8);  // digits above
    unsigned* hist = x.hist[j & 1];
    for (int i0 = 0; i0 < n; i0 += kThreads) {  // uniform trip count
      const int i = i0 + tid;
      Key4 k;
      int digit = 256;                           // 256: not counted
      if (i < n && get(i, k)) {
        bool m = (k.w[wi] & hm) == (pre.w[wi] & hm);
        for (int u = 0; u < wi; ++u) m = m && k.w[u] == pre.w[u];
        if (m) digit = static_cast<int>((k.w[wi] >> sh) & 255u);
      }
      // one shared atomic per distinct digit of the warp: keys that share
      // their top digits would serialize on one bin
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    // suffix sums S(b) = hist[b] + ... + hist[255] on threads 0..255; the
    // other histogram is cleared for the next digit
    for (int b = tid; b < 256; b += kThreads) x.hist[(j + 1) & 1][b] = 0u;
    int s = 0, h = 0;
    if (tid < 256) {
      h = s = static_cast<int>(hist[tid]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_down_sync(kFull, s, o);
        if (lane + o < 32) s += v;
      }
      if (lane == 0) x.sc[warp] = s;
    }
    __syncthreads();
    if (tid < 256) {
      int total = 0;
      for (int w = 0; w < 8; ++w) total += x.sc[w];
      for (int w = warp + 1; w < 8; ++w) s += x.sc[w];
      if (j == 0 && total <= want) {
        if (tid == 0) x.sc[8] = -1;
      } else if (s >= want && s - h < want) {  // the bucket crossing want
        x.sc[8] = tid;
        x.sc[9] = s - h;
        x.sc[10] = h;
      }
    }
    __syncthreads();
    const int b = x.sc[8];
    if (b < 0) return pre;  // at most `want`: every valid key is >= 0
    const int above = x.sc[9], cnt = x.sc[10];
    pre.w[wi] |= static_cast<uint32_t>(b) << sh;
    want -= above;
    if (cnt == want) return pre;  // the bucket is taken whole
    if (cnt <= 32) {
      // the bucket's keys, ranked by one warp: the want-th greatest
      const uint32_t hb = ~0u << sh;  // digits through this one
      for (int i0 = 0; i0 < n; i0 += kThreads) {
        const int i = i0 + tid;
        Key4 k;
        if (i >= n || !get(i, k) || (k.w[wi] & hb) != pre.w[wi]) continue;
        bool m = true;
        for (int u = 0; u < wi; ++u) m = m && k.w[u] == pre.w[u];
        if (m) x.small[atomicAdd(&x.n_small, 1)] = k;
      }
      __syncthreads();
      if (warp == 0 && lane < cnt) {
        const Key4 me = x.small[lane];
        int rank = 0;  // keys of the bucket greater than this one
        for (int v = 0; v < cnt; ++v)
          rank += v != lane && key4_ge(x.small[v], me);
        if (rank == want - 1) x.thr = me;
      }
      __syncthreads();
      return x.thr;
    }
  }
  return pre;
}

// The n-th (from 0) set bit of m; m has more than n set bits.
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  for (; n > 0; --n) m &= m - 1u;
  return __ffs(m) - 1;
}

// Host: where a launch keeps the summaries of a pool of cap slots.  The
// launch needs `fixed` bytes of dynamic shared memory of its own; the
// summaries join them while the whole fits the card's opt-in beside the
// kernel's static shared memory (*in_shared), else they go to the caller's
// global scratch.  *smem is the launch's dynamic shared memory; the opt-in
// attribute of the kernel that runs is raised when it and the static shared
// memory pass 48 KB.
template <typename KShared, typename KGlobal>
inline cudaError_t plan_summaries(KShared k_shared, KGlobal k_global,
                                  size_t fixed, int cap, bool* in_shared,
                                  size_t* smem) {
  const size_t sums = (size_t)kSummaryBytes * ((cap + kChunk - 1) / kChunk);
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaError_t e = cudaFuncGetAttributes(&attr, k_shared);
  if (e != cudaSuccess) return e;
  *in_shared = fixed + sums + attr.sharedSizeBytes <= (size_t)optin;
  *smem = *in_shared ? fixed + sums : fixed;
  if (*smem + attr.sharedSizeBytes > (size_t)optin)
    return cudaErrorInvalidValue;  // not even the fixed part fits
  if (*smem + attr.sharedSizeBytes > 48 * 1024) {
    e = *in_shared ? cudaFuncSetAttribute(
                         k_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(*smem))
                   : cudaFuncSetAttribute(
                         k_global, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(*smem));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace pool
