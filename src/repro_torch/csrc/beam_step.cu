// beam_loop: the whole pool-frontier search loop of the mega core, every
// trip of every row inside one launch.
//
// Replaces the Pallas kernel src/repro/kernels/beam_step.py (_kernel, entry
// fused_beam_step), which fuses ONE trip of core/mega.py's loop into one
// launch and leaves the loop (and its exit test) to an XLA while_loop.  The
// rows of the mega core are independent, so a row that runs its own trips
// until !(n_out < k && any slot live && pops < max_pops) produces exactly the
// reference's per-row pops, emissions, iters and overflow latch; here each
// row is one thread block that loops in the kernel, and no trip returns to
// the host.
//
// One trip of a row, each phase ended by __syncthreads():
//   pop     block-wide lex-argmax over the row's live slots in the total
//           order (score desc, d0 asc, d1 desc; first index on a full tie;
//           all-free rows never get here), the slot is freed;
//   emit    a popped singleton goes to output slot n_out (slot k, the
//           reference's trash slot, is never needed: a live row has
//           n_out < k);
//   split   mid = (d0 + d1) / 2, extents from sep_pos (hi = n when
//           mid >= n_docs), the left child's Q counts through the shared
//           warp descent of wtbc_descent.cuh (one warp per query word),
//           tf2 = tf - tf1;
//   score   round each product, add from left to right over Q
//           (__fmul_rn / __fadd_rn, so nvcc cannot contract into FMA);
//   insert  the two children into the lowest free slots, AND/OR validity as
//           the reference's seg_valid; no free slot latches overflowed and
//           writes nothing.
//
// The pools are the port's core/heap.py Pool layout: rows of cap + 1 slots,
// the last one a scratch slot of the plain bulk insert that the kernel never
// reads or writes.  The row's occupied-slot count (Pool.size) is written
// back when the row stops.
//
// What bounds it on the H100: latency.  A row's trips are a dependent chain
// (each pop depends on the previous inserts), each trip a block reduction
// plus a three-level gather chain, and a batch has only B rows, so at B = 8
// eight SMs work and the rest idle.  The design keeps each trip short
// instead: the pool stays in the caller's global arrays (updated in place,
// L2-resident), and a per-row high-water mark hw (every slot >= hw is free)
// bounds the reduction to the slots that were ever live rather than the
// n_docs + 2 capacity.  The first-free-slot rule stays exact: the two lowest
// holes below hw come out of the same reduction as the argmax, and an insert
// never lands above hw.
#include <climits>
#include <math_constants.h>

#include "wtbc_descent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 64;
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

__device__ __forceinline__ Key shfl_key(const Key& k, int o) {
  return {__shfl_xor_sync(kFull, k.s, o), __shfl_xor_sync(kFull, k.d0, o),
          __shfl_xor_sync(kFull, k.d1, o), __shfl_xor_sync(kFull, k.idx, o)};
}

// (a1, a2) <- the two lowest of {a1, a2, b1, b2}; pairs ascending and
// disjoint, INT_MAX for "none".
__device__ __forceinline__ void merge_low2(int& a1, int& a2, int b1, int b2) {
  const int lo = min(a1, b1);
  const int hi = a1 < b1 ? min(a2, b1) : min(a1, b2);
  a1 = lo;
  a2 = hi;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
beam_loop_kernel(wtbc::Levels lv, wtbc::WordTables t,
                 const int32_t* __restrict__ sep_pos, int n, int n_docs,
                 const int32_t* __restrict__ words,
                 const int32_t* __restrict__ wmask,
                 const float* __restrict__ idf_w, int Q, float* pool_s,
                 int32_t* pool_d0, int32_t* pool_d1, int32_t* pool_tf,
                 int32_t* size_g, int cap,
                 int32_t* out_docs, float* out_scores, int k, int32_t* n_out_g,
                 int32_t* iters_g, int32_t* pops_g, int32_t* ovf_g,
                 int32_t* status_g, int conjunctive, int max_pops,
                 int max_trips) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stride = (size_t)cap + 1;  // the scratch slot past cap
  float* ps = pool_s + row * stride;
  int32_t* p0 = pool_d0 + row * stride;
  int32_t* p1 = pool_d1 + row * stride;
  int32_t* ptf = pool_tf + row * stride * Q;
  const int32_t* wq = words + (size_t)row * Q;
  const int32_t* wm = wmask + (size_t)row * Q;
  const float* iw = idf_w + (size_t)row * Q;
  int32_t* od = out_docs + (size_t)row * (k + 1);
  float* os = out_scores + (size_t)row * (k + 1);

  __shared__ Key warp_key[kWarps];
  __shared__ int warp_a[kWarps], warp_b[kWarps];
  __shared__ int tf_pop[kMaxQ], tf_left[kMaxQ];
  __shared__ int sh_hw, sh_live, sh_n_out, sh_iters, sh_pops, sh_ovf;
  __shared__ int sh_multi, sh_j, sh_d0, sh_d1, sh_mid, sh_lo, sh_hi;
  __shared__ int sh_cand[2];

  // ---- high-water mark and live count: one scan of the whole row
  {
    int hi = -1, cnt = 0;
    for (int i = tid; i < cap; i += kThreads)
      if (ps[i] > -CUDART_INF_F) {
        hi = i;
        ++cnt;
      }
    hi = warp_max(hi);
    cnt = wtbc::warp_sum(cnt);
    if (lane == 0) {
      warp_a[warp] = hi;
      warp_b[warp] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      int h = -1, c = 0;
      for (int w = 0; w < kWarps; ++w) {
        h = max(h, warp_a[w]);
        c += warp_b[w];
      }
      sh_hw = h + 1;
      sh_live = c;
      sh_n_out = n_out_g[row];
      sh_iters = iters_g[row];
      sh_pops = pops_g[row];
      sh_ovf = ovf_g[row];
    }
    __syncthreads();
  }

  for (int trip = 0;; ++trip) {
    if (!(sh_n_out < k && sh_live > 0 && (max_pops < 0 || sh_pops < max_pops)))
      break;
    if (trip >= max_trips) {  // cannot happen for a well-formed pool
      if (tid == 0) status_g[row] = 1;
      break;
    }
    const int hw = sh_hw;

    // ---- pop: lex-argmax over [0, hw) and the two lowest holes there
    Key best = {-CUDART_INF_F, 0, 0, -1};
    int f1 = INT_MAX, f2 = INT_MAX;
    for (int i = tid; i < hw; i += kThreads) {
      const float s = ps[i];
      if (s > -CUDART_INF_F) {
        const Key c = {s, p0[i], p1[i], i};
        if (precedes(c, best)) best = c;
      } else if (f1 == INT_MAX) {
        f1 = i;
      } else if (f2 == INT_MAX) {
        f2 = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Key other = shfl_key(best, o);
      if (precedes(other, best)) best = other;
      const int g1 = __shfl_xor_sync(kFull, f1, o);
      const int g2 = __shfl_xor_sync(kFull, f2, o);
      merge_low2(f1, f2, g1, g2);
    }
    if (lane == 0) {
      warp_key[warp] = best;
      warp_a[warp] = f1;
      warp_b[warp] = f2;
    }
    __syncthreads();

    // ---- emit / split bookkeeping (one thread)
    if (tid == 0) {
      Key b = warp_key[0];
      int a1 = warp_a[0], a2 = warp_b[0];
      for (int w = 1; w < kWarps; ++w) {
        if (precedes(warp_key[w], b)) b = warp_key[w];
        merge_low2(a1, a2, warp_a[w], warp_b[w]);
      }
      const int j = b.idx;  // live > 0, so a slot was found
      ps[j] = -CUDART_INF_F;
      sh_live -= 1;
      sh_iters += 1;
      sh_pops += 1;
      sh_j = j;
      sh_d0 = b.d0;
      sh_d1 = b.d1;
      const bool single = (b.d1 - b.d0) == 1;
      if (single) {
        od[sh_n_out] = b.d0;
        os[sh_n_out] = b.s;
        sh_n_out += 1;
      }
      sh_multi = !single;
      const int mid = (b.d0 + b.d1) / 2;  // d0, d1 >= 0: floor division
      sh_mid = mid;
      sh_lo = b.d0 == 0 ? 0 : sep_pos[b.d0 - 1] + 1;
      sh_hi = mid >= n_docs ? n : (mid == 0 ? 0 : sep_pos[mid - 1] + 1);
      // free slots after the pop, lowest first: the holes below hw and the
      // popped slot (all < hw), then hw, hw + 1, ...
      int c0 = min(a1, j), c1 = max(a1, j);
      c1 = min(c1, a2);
      sh_cand[0] = c0;
      sh_cand[1] = min(c1, hw);
    }
    __syncthreads();

    if (sh_multi) {
      for (int q = tid; q < Q; q += kThreads)
        tf_pop[q] = ptf[(size_t)sh_j * Q + q];
      for (int q = warp; q < Q; q += kWarps) {
        const int c = wtbc::warp_count_range(lv, t, __ldg(wq + q), sh_lo, sh_hi);
        if (lane == 0) tf_left[q] = __ldg(wm + q) ? c : 0;
      }
      __syncthreads();
      if (tid == 0) {
        float s1 = 0.f, s2 = 0.f;
        bool all1 = true, all2 = true, any_w = false;
        for (int q = 0; q < Q; ++q) {
          const int t1 = tf_left[q];
          const int t2 = tf_pop[q] - t1;
          tf_pop[q] = t2;
          const float w = __ldg(iw + q);
          s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(t1), w));
          s2 = __fadd_rn(s2, __fmul_rn(static_cast<float>(t2), w));
          const bool m = __ldg(wm + q) != 0;
          any_w |= m;
          all1 &= (t1 > 0) || !m;
          all2 &= (t2 > 0) || !m;
        }
        const bool ok1 = conjunctive ? (all1 && any_w) : (s1 > 0.f);
        const bool ok2 = conjunctive ? (all2 && any_w) : (s2 > 0.f);
        int ci = 0;
        const int d0s[2] = {sh_d0, sh_mid}, d1s[2] = {sh_mid, sh_d1};
        const float ss[2] = {s1, s2};
        const bool oks[2] = {ok1, ok2};
        const int* tfs[2] = {tf_left, tf_pop};
        for (int c = 0; c < 2; ++c) {
          if (!oks[c]) continue;
          const int slot = sh_cand[ci];
          if (slot >= cap) {
            sh_ovf = 1;
            continue;
          }
          ps[slot] = ss[c];
          p0[slot] = d0s[c];
          p1[slot] = d1s[c];
          for (int q = 0; q < Q; ++q) ptf[(size_t)slot * Q + q] = tfs[c][q];
          ++ci;
          sh_live += 1;
          sh_hw = max(sh_hw, slot + 1);
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    n_out_g[row] = sh_n_out;
    iters_g[row] = sh_iters;
    pops_g[row] = sh_pops;
    ovf_g[row] = sh_ovf;
    size_g[row] = sh_live;
  }
}

}  // namespace

extern "C" int beam_loop(const void* d0, const void* c0, int nb0, int len0,
                         const void* d1, const void* c1, int nb1, int len1,
                         const void* d2, const void* c2, int nb2, int len2,
                         int block, const void* cw, const void* cw_len,
                         const void* node_off, const void* base_rank,
                         const void* sep_pos, int n, int n_docs,
                         const void* words, const void* wmask,
                         const void* idf_w, int q, void* pool_s, void* pool_d0,
                         void* pool_d1, void* pool_tf, void* size, int cap,
                         void* out_docs,
                         void* out_scores, int k, void* n_out, void* iters,
                         void* pops, void* overflowed, void* status,
                         int conjunctive, int max_pops, int max_trips, int b,
                         void* stream) {
  if (q < 1 || q > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  beam_loop_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(sep_pos), n, n_docs,
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(wmask),
      static_cast<const float*>(idf_w), q, static_cast<float*>(pool_s),
      static_cast<int32_t*>(pool_d0), static_cast<int32_t*>(pool_d1),
      static_cast<int32_t*>(pool_tf), static_cast<int32_t*>(size), cap,
      static_cast<int32_t*>(out_docs),
      static_cast<float*>(out_scores), k, static_cast<int32_t*>(n_out),
      static_cast<int32_t*>(iters), static_cast<int32_t*>(pops),
      static_cast<int32_t*>(overflowed), static_cast<int32_t*>(status),
      conjunctive, max_pops, max_trips);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* beam_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
