// heap_loop: the whole search loop of the heap core at beam width P >= 2,
// every trip of every row inside one launch.
//
// Replaces no TPU kernel: the reference runs this loop as one compiled
// lax.while_loop (src/repro/core/ranked.py:364-427, topk_dr_batch) whose
// body calls K1 (the Pallas wavelet_count), so on the TPU the whole search
// is one device program.  The port drove it from the host instead: one K1
// launch and a few hundred small PyTorch launches a trip.  Here each row is
// one thread block that runs its trips until !(n_out < k && size > 0 &&
// pops < max_pops); a stopped row stays stopped, so the row's trip t is the
// batch's trip t, and no trip returns to the host.
//
// One trip of a row (16 warps) computes exactly kernels/heap_loop.py's
// heap_trip (the plain loop):
//   pop      (warp 0) the nv = min(size, P) lex-greatest slots, one at a
//            time over the chunk summaries (pool.cuh), each slot freed and
//            its chunk summarised again before the next; the popped keys
//            and tf rows go to shared memory;
//   emit     a popped singleton is the next answer iff it lex-beats every
//            popped multi and the pending top after the pops (whose
//            descendants they bound); emitted ones fill output slots
//            n_out, n_out + 1, ... below k in pop order, the rest are
//            pushed back;
//   split    every popped multi at mid = (d0 + d1) / 2, its root extent
//            from sep_pos;
//   descend  (all warps) the left child's count of every (multi, word) by
//            2·nm·Q warp tasks, one per endpoint (wtbc_descent.cuh);
//            tf2 = tf − tf1;
//   score    (warp 0) lane m scores multi m's two children, each product
//            rounded and added from left to right over Q (__fmul_rn /
//            __fadd_rn, the order of core/scoring.dot_q), AND/OR validity
//            as seg_valid;
//   push     (warp 0) up to 3·P lanes, parent-major (left, right, unemitted
//            singleton): the r-th enabled push takes the row's r-th lowest
//            free slot — the first chunk at or after the previous push's
//            with a free slot, found by a ballot over the summaries — or,
//            with no free slot left, latches overflowed and is dropped.
// The row's live width nv of each trip goes to widths[row, trip] (the
// caller zeroes the buffer), from which the caller computes the
// reference's pad-waste counter `padded` (core/ranked.py:
// padded_from_widths): it is the one leaf that couples rows.
//
// Shared memory: the chunk summaries as in beam_loop (56 bytes per 256
// slots, in the global scratch when they do not fit); the popped tf rows
// and the descents' endpoint ranks, 12·P·Q bytes of dynamic shared memory
// (48 KB at P = Q = 64); static: the P popped keys, the multis' extents and
// scores, the 3·P push lanes and the word tables, about 9 KB.
//
// What bounds it on the H100: latency, as beam_loop.  A row's trips are a
// dependent chain, its P pops one after another (each a summary reduction
// and a chunk re-read), the descents three memory round trips per
// endpoint, the pushes one after another; B rows use B of 132 SMs.  The
// design keeps each step out of device memory where it can (summaries,
// keys, tf rows and ranks in shared memory) and spreads the descents, the
// one part with parallel work, over all 16 warps.
#include <climits>
#include <math_constants.h>

#include "pool.cuh"
#include "wtbc_descent.cuh"

namespace {

using pool::kChunk;
using pool::kFull;
using pool::Key;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 64;
constexpr int kMaxP = 64;
constexpr int kMaxPush = 3 * kMaxP;

// Strict precedence in the total order on (s, d0, d1) alone — the plain
// loop's lex_gt; distinct segments never tie.
__device__ __forceinline__ bool lex_gt(float as, int a0, int a1, float bs,
                                       int b0, int b1) {
  return as > bs || (as == bs && (a0 < b0 || (a0 == b0 && a1 > b1)));
}

// kShared: the summaries in dynamic shared memory after the 3·P·Q ints of
// tf rows and ranks; else in the row's kSummaryInts * n_chunks ints of
// `summaries`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
heap_loop_kernel(wtbc::Levels lv, wtbc::WordTables t,
                 const int32_t* __restrict__ sep_pos, int n, int n_docs,
                 const int32_t* __restrict__ words,
                 const int32_t* __restrict__ wmask,
                 const float* __restrict__ idf_w, int Q, int P, float* pool_s,
                 int32_t* pool_d0, int32_t* pool_d1, int32_t* pool_tf,
                 int32_t* size_g, int cap, int32_t* out_docs,
                 float* out_scores, int k, int32_t* n_out_g, int32_t* iters_g,
                 int32_t* pops_g, int32_t* ovf_g, int32_t* status_g,
                 int32_t* widths, int conjunctive, int max_pops,
                 int max_trips, int32_t* summaries) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stride = (size_t)cap + 1;  // the scratch slot past cap
  float* ps = pool_s + row * stride;
  int32_t* p0 = pool_d0 + row * stride;
  int32_t* p1 = pool_d1 + row * stride;
  int32_t* ptf = pool_tf + row * stride * Q;
  int32_t* od = out_docs + (size_t)row * (k + 1);
  float* os = out_scores + (size_t)row * (k + 1);
  int32_t* wrow = widths + (size_t)row * max_trips;
  const int n_chunks = (cap + kChunk - 1) / kChunk;

  extern __shared__ int4 dyn[];
  int* const tf_pop = reinterpret_cast<int*>(dyn);  // (P, Q) popped tf rows
  int* const leaf0 = tf_pop + P * Q;                 // (nm, Q) lo ranks
  int* const leaf1 = leaf0 + P * Q;                  // (nm, Q) hi ranks
  int* const dw =
      kShared ? leaf1 + P * Q
              : summaries + (size_t)row * pool::kSummaryInts * n_chunks;
  const pool::Summaries sm = pool::summaries_at(dw, n_chunks);
  __shared__ wtbc::WordPath path[kMaxQ];
  __shared__ int wm_s[kMaxQ];
  __shared__ float iw_s[kMaxQ];
  __shared__ int warp_live[kWarps], warp_top[kWarps];
  // the trip's popped keys, which ones were emitted, and its multis (pop
  // lane, split point, root extent, children's scores and validity bits)
  __shared__ float pk_s[kMaxP];
  __shared__ int pk_d0[kMaxP], pk_d1[kMaxP], pk_emit[kMaxP];
  __shared__ int m_i[kMaxP], m_mid[kMaxP], m_lo[kMaxP], m_hi[kMaxP];
  __shared__ float m_s1[kMaxP], m_s2[kMaxP];
  __shared__ int m_ok[kMaxP];
  // the push lanes: key, and where the tf row comes from (src >= 0: the
  // left (2m) or right (2m + 1) child of multi m; src < 0: popped lane
  // -src - 1)
  __shared__ float pu_s[kMaxPush];
  __shared__ int pu_d0[kMaxPush], pu_d1[kMaxPush], pu_src[kMaxPush];
  // loop state: written by warp 0 only once the loop runs
  __shared__ int sh_hw, sh_live, sh_n_out, sh_iters, sh_pops, sh_ovf;
  __shared__ int sh_nv, sh_npush;
  // per trip parity: warp 0 may write trip t + 1's while a warp still reads
  // trip t's (it cannot get two trips ahead: a barrier lies between)
  __shared__ int sh_stop[2], sh_nm[2];

  // ---- the row's words, and every chunk summarised (warp per chunk)
  for (int q = tid; q < Q; q += kThreads) {
    path[q] = wtbc::load_path(t, __ldg(words + (size_t)row * Q + q));
    wm_s[q] = __ldg(wmask + (size_t)row * Q + q);
    iw_s[q] = __ldg(idf_w + (size_t)row * Q + q);
  }
  __syncthreads();
  pool::block_summarise<kWarps>(sm, n_chunks, ps, p0, p1, cap, warp_live,
                                warp_top, &sh_hw, &sh_live);
  if (tid == 0) {
    sh_n_out = n_out_g[row];
    sh_iters = iters_g[row];
    sh_pops = pops_g[row];
    sh_ovf = ovf_g[row];
  }
  __syncthreads();

  for (int trip = 0;; ++trip) {
    const int par = trip & 1;
    // ---- pop, emit, split (warp 0)
    if (warp == 0) {
      const bool go = sh_n_out < k && sh_live > 0 &&
                      (max_pops < 0 || sh_pops < max_pops);
      const bool bad = go && trip >= max_trips;  // not for a well-formed pool
      if (!go || bad) {
        if (lane == 0) {
          sh_stop[par] = 1;
          if (bad) status_g[row] = 1;
        }
      } else {
        const int nv = min(sh_live, P);
        const int active = pool::active_chunks(sh_hw, n_chunks);
        for (int i = 0; i < nv; ++i) {
          const Key best = pool::warp_best_key(sm, active);
          const int j = best.idx;  // i < nv <= live: a slot is found
          for (int q = lane; q < Q; q += 32)
            tf_pop[i * Q + q] = ptf[(size_t)j * Q + q];
          if (lane == 0) {
            pk_s[i] = best.s;
            pk_d0[i] = best.d0;
            pk_d1[i] = best.d1;
            ps[j] = -CUDART_INF_F;
          }
          __syncwarp();
          pool::warp_summarise(sm, j / kChunk, ps, p0, p1, cap);
          __syncwarp();
        }
        // the pending top after the pops (idx < 0: the pool is empty)
        const Key top = pool::warp_best_key(sm, active);
        if (lane == 0) {
          // the emission bound: the lex-max of the popped multis and top
          bool has = top.idx >= 0;
          float bs = top.s;
          int b0 = top.d0, b1 = top.d1;
          for (int i = 0; i < nv; ++i) {
            if (pk_d1[i] - pk_d0[i] == 1) continue;
            if (!has || lex_gt(pk_s[i], pk_d0[i], pk_d1[i], bs, b0, b1)) {
              has = true;
              bs = pk_s[i];
              b0 = pk_d0[i];
              b1 = pk_d1[i];
            }
          }
          int ne = 0, nm = 0;
          for (int i = 0; i < nv; ++i) {
            if (pk_d1[i] - pk_d0[i] != 1) {
              m_i[nm++] = i;
              pk_emit[i] = 0;
              continue;
            }
            const bool emit =
                !has || lex_gt(pk_s[i], pk_d0[i], pk_d1[i], bs, b0, b1);
            pk_emit[i] = emit;
            if (!emit) continue;
            const int slot = sh_n_out + ne;
            if (slot < k) {
              od[slot] = pk_d0[i];
              os[slot] = pk_s[i];
            }
            ++ne;
          }
          sh_n_out = min(sh_n_out + ne, k);
          sh_live -= nv;
          sh_iters += 1;
          sh_pops += nv;
          sh_nv = nv;
          sh_nm[par] = nm;
          wrow[trip] = nv;
          sh_stop[par] = 0;
        }
        __syncwarp();
        // the multis' split points and root extents, lane per multi
        for (int m = lane; m < sh_nm[par]; m += 32) {
          const int i = m_i[m];
          const int d0 = pk_d0[i], mid = (d0 + pk_d1[i]) / 2;  // d0 >= 0
          m_mid[m] = mid;
          m_lo[m] = d0 > 0 ? sep_pos[d0 - 1] + 1 : 0;
          m_hi[m] = mid >= n_docs ? n : (mid > 0 ? sep_pos[mid - 1] + 1 : 0);
        }
      }
      __syncwarp();
    }
    __syncthreads();
    if (sh_stop[par]) break;
    const int nm = sh_nm[par];

    // ---- descent: one warp per (multi, word, endpoint)
    if (nm > 0) {
      for (int task = warp; task < 2 * nm * Q; task += kWarps) {
        const int m = task / (2 * Q), r = task - m * 2 * Q;
        const int q = r >> 1, e = r & 1;
        const int rank = wm_s[q] ? wtbc::warp_endpoint_rank(
                                       lv, path[q], e ? m_hi[m] : m_lo[m])
                                 : 0;
        if (lane == 0) (e ? leaf1 : leaf0)[m * Q + q] = rank;
      }
      __syncthreads();
    }

    // ---- score and push (warp 0)
    if (warp == 0) {
      for (int m = lane; m < nm; m += 32) {
        const int i = m_i[m];
        float s1 = 0.f, s2 = 0.f;
        bool all1 = true, all2 = true, any_w = false;
        for (int q = 0; q < Q; ++q) {
          const int t1 = leaf1[m * Q + q] - leaf0[m * Q + q];
          const int t2 = tf_pop[i * Q + q] - t1;
          const float w = iw_s[q];
          const bool msk = wm_s[q] != 0;
          s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(t1), w));
          s2 = __fadd_rn(s2, __fmul_rn(static_cast<float>(t2), w));
          all1 &= (t1 > 0) || !msk;
          all2 &= (t2 > 0) || !msk;
          any_w |= msk;
        }
        m_s1[m] = s1;
        m_s2[m] = s2;
        const bool ok1 = conjunctive ? (all1 && any_w) : (s1 > 0.f);
        const bool ok2 = conjunctive ? (all2 && any_w) : (s2 > 0.f);
        m_ok[m] = (ok1 ? 1 : 0) | (ok2 ? 2 : 0);
      }
      __syncwarp();
      if (lane == 0) {  // the enabled push lanes, parent-major
        int np = 0, m = 0;
        for (int i = 0; i < sh_nv; ++i) {
          if (pk_d1[i] - pk_d0[i] != 1) {
            const int mid = m_mid[m];
            if (m_ok[m] & 1) {
              pu_s[np] = m_s1[m];
              pu_d0[np] = pk_d0[i];
              pu_d1[np] = mid;
              pu_src[np++] = 2 * m;
            }
            if (m_ok[m] & 2) {
              pu_s[np] = m_s2[m];
              pu_d0[np] = mid;
              pu_d1[np] = pk_d1[i];
              pu_src[np++] = 2 * m + 1;
            }
            ++m;
          } else if (!pk_emit[i]) {
            pu_s[np] = pk_s[i];
            pu_d0[np] = pk_d0[i];
            pu_d1[np] = pk_d1[i];
            pu_src[np++] = -i - 1;
          }
        }
        sh_npush = np;
      }
      __syncwarp();
      const int np = sh_npush;
      int cur = 0;  // no chunk below cur has a free slot
      for (int r = 0; r < np; ++r) {
        int ch = -1;
        for (int base = cur; base < n_chunks; base += 32) {
          const int c = base + lane;
          const unsigned has =
              __ballot_sync(kFull, c < n_chunks && sm.f1[c] != INT_MAX);
          if (has) {
            ch = base + __ffs(has) - 1;
            break;
          }
        }
        if (ch < 0) {  // full: this push and every later one are dropped
          if (lane == 0) sh_ovf = 1;
          break;
        }
        cur = ch;
        const int slot = sm.f1[ch];
        const int src = pu_src[r];
        for (int q = lane; q < Q; q += 32) {
          int v;
          if (src < 0) {
            v = tf_pop[(-src - 1) * Q + q];
          } else {
            const int m = src >> 1;
            const int t1 = leaf1[m * Q + q] - leaf0[m * Q + q];
            v = (src & 1) ? tf_pop[m_i[m] * Q + q] - t1 : t1;
          }
          ptf[(size_t)slot * Q + q] = v;
        }
        __syncwarp();  // every lane has read sm.f1[ch] before it changes
        if (lane == 0) {
          ps[slot] = pu_s[r];
          p0[slot] = pu_d0[r];
          p1[slot] = pu_d1[r];
          pool::note_insert(sm, {pu_s[r], pu_d0[r], pu_d1[r], slot});
          sh_live += 1;
          sh_hw = max(sh_hw, slot + 1);
        }
        __syncwarp();
        int g1, g2;
        pool::mask_low2(sm, ch, g1, g2);
        if (lane == 0) {
          sm.f1[ch] = g1;
          sm.f2[ch] = g2;
        }
        __syncwarp();
      }
      __syncwarp();
    }
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

extern "C" int heap_loop(const void* d0, const void* c0, int nb0, int len0,
                         const void* d1, const void* c1, int nb1, int len1,
                         const void* d2, const void* c2, int nb2, int len2,
                         int block, const void* cw, const void* cw_len,
                         const void* node_off, const void* base_rank,
                         const void* sep_pos, int n, int n_docs,
                         const void* words, const void* wmask,
                         const void* idf_w, int q, int p, void* pool_s,
                         void* pool_d0, void* pool_d1, void* pool_tf,
                         void* size, int cap, void* out_docs,
                         void* out_scores, int k, void* n_out, void* iters,
                         void* pops, void* overflowed, void* status,
                         void* widths, int conjunctive, int max_pops,
                         int max_trips, int b, void* summaries,
                         void* stream) {
  if (q < 1 || q > kMaxQ || p < 2 || p > kMaxP || cap < 1 || max_trips < 1 ||
      summaries == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the popped tf rows and the endpoint ranks: 3·P·Q ints of dynamic shared
  // memory; the summaries after them while they fit the opt-in, else in the
  // caller's scratch of b * kSummaryInts * n_chunks ints
  bool in_shared = false;
  size_t smem = 0;
  const cudaError_t e = pool::plan_summaries(
      heap_loop_kernel<true>, heap_loop_kernel<false>, (size_t)12 * p * q,
      cap, &in_shared, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  auto kernel = in_shared ? heap_loop_kernel<true> : heap_loop_kernel<false>;
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(sep_pos), n, n_docs,
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(wmask),
      static_cast<const float*>(idf_w), q, p, static_cast<float*>(pool_s),
      static_cast<int32_t*>(pool_d0), static_cast<int32_t*>(pool_d1),
      static_cast<int32_t*>(pool_tf), static_cast<int32_t*>(size), cap,
      static_cast<int32_t*>(out_docs), static_cast<float*>(out_scores), k,
      static_cast<int32_t*>(n_out), static_cast<int32_t*>(iters),
      static_cast<int32_t*>(pops), static_cast<int32_t*>(overflowed),
      static_cast<int32_t*>(status), static_cast<int32_t*>(widths),
      conjunctive, max_pops, max_trips, static_cast<int32_t*>(summaries));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heap_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
