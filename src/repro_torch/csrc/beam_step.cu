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
// One trip of a row (16 warps):
//   pop     (warp 0) lex-argmax in the total order (score desc, d0 asc,
//           d1 desc; first index on a full tie) over the per-chunk
//           summaries in shared memory, and the row's two lowest free
//           slots from the same reduction; the slot is freed;
//   emit    a popped singleton goes to output slot n_out (slot k, the
//           reference's trash slot, is never needed: a live row has
//           n_out < k);
//   split   mid = (d0 + d1) / 2, extents from sep_pos (the two cells read
//           by two lanes at once, hi = n when mid >= n_docs); the left
//           child's Q counts by 2·Q warps, one per (word, endpoint)
//           (wtbc_descent.cuh: warp_endpoint_rank), tf2 = tf - tf1; at the
//           same time the last warp summarises the popped slot's chunk
//           again;
//   score   (warp 0) lane q rounds word q's products, every lane adds them
//           from left to right over Q (__fmul_rn / __fadd_rn, so nvcc
//           cannot contract into FMA);
//   insert  (warp 0) the two children into the lowest free slots, AND/OR
//           validity as the reference's seg_valid; no free slot latches
//           overflowed and writes nothing; each insert updates its chunk's
//           summary in place (the new key against the best, its bit out of
//           the free mask, the chunk's two lowest free slots from the mask).
//
// Per-chunk summaries (pool.cuh, shared with heap_loop.cu).  The row's
// slots fall in chunks of 256, each summarised by its best live key, its two
// lowest free slots and a free bit per slot, in dynamic shared memory while
// they fit one block's opt-in (about 1 M slots on an H100), else in a global
// scratch; a high-water mark bounds the pop to the chunks in use, and the
// pool stays slot for slot equal to the plain loop's.
//
// The pools are the port's core/heap.py Pool layout: rows of cap + 1 slots,
// the last one a scratch slot of the plain bulk insert that the kernel never
// reads or writes.  The row's occupied-slot count (Pool.size) is written
// back when the row stops.
//
// What bounds it on the H100: latency.  A row's trips are a dependent chain
// (each pop depends on the previous inserts), and a batch has only B rows,
// so at B = 8 eight SMs work and the rest idle.  A trip is kept short: the
// pop reads a few hundred bytes of shared memory instead of scanning the
// row's slots in device memory; a count is three memory round trips in
// series (one per level, both endpoints of every word side by side, each
// rank reading the nearer end of its tile with all loads in flight), and
// the popped chunk is summarised again in its shadow; the per-word tables,
// idf weights and mask sit in shared memory; one trip has two block
// barriers (one for a singleton pop), the rest is warp 0 alone.
#include <climits>
#include <math_constants.h>

#include "pool.cuh"
#include "wtbc_descent.cuh"

namespace {

using pool::kChunk;
using pool::kFull;
using pool::Key;
using pool::precedes;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHelper = kWarps - 1;       // re-summarises during the descent
constexpr int kMaxQ = 64;

// kShared: the summaries in dynamic shared memory; else in the row's
// kSummaryInts * n_chunks ints of `summaries`.
template <bool kShared>
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
  const int n_chunks = (cap + kChunk - 1) / kChunk;

  extern __shared__ int4 dyn[];
  int* const dw =
      kShared ? reinterpret_cast<int*>(dyn)
              : summaries + (size_t)row * pool::kSummaryInts * n_chunks;
  const pool::Summaries sm = pool::summaries_at(dw, n_chunks);
  __shared__ wtbc::WordPath path[kMaxQ];
  __shared__ int wm_s[kMaxQ];
  __shared__ float iw_s[kMaxQ];
  __shared__ int leaf[2][kMaxQ], tf_pop[kMaxQ];
  __shared__ int warp_live[kWarps], warp_top[kWarps];
  // loop state: written by warp 0 only once the loop runs
  __shared__ int sh_hw, sh_live, sh_n_out, sh_iters, sh_pops, sh_ovf;
  __shared__ int sh_j, sh_d0, sh_d1, sh_mid, sh_lo, sh_hi;
  // per trip parity: warp 0 may write trip t + 1's while a warp still reads
  // trip t's (it cannot get two trips ahead: a barrier lies between)
  __shared__ int sh_stop[2], sh_multi[2];
  __shared__ int sh_cand[2], sh_slot[2];

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
    // ---- pop and bookkeeping (warp 0)
    if (warp == 0) {
      const bool go = sh_n_out < k && sh_live > 0 &&
                      (max_pops < 0 || sh_pops < max_pops);
      const bool bad = go && trip >= max_trips;  // not for a well-formed pool
      if (!go || bad) {
        if (lane == 0) {
          sh_stop[trip & 1] = 1;
          if (bad) status_g[row] = 1;
        }
      } else {
        Key best;
        int f1, f2;
        pool::warp_best(sm, pool::active_chunks(sh_hw, n_chunks), best, f1,
                        f2);
        const int j = best.idx;  // live > 0, so a slot was found
        const bool single = (best.d1 - best.d0) == 1;
        const int mid = (best.d0 + best.d1) / 2;  // d0, d1 >= 0: floor
        // the split's two sep_pos cells from two lanes, the popped tf from
        // every lane, all at once
        int sep = 0;
        if (!single && lane == 0 && best.d0 > 0) sep = sep_pos[best.d0 - 1] + 1;
        if (!single && lane == 1 && mid > 0 && mid < n_docs)
          sep = sep_pos[mid - 1] + 1;
        if (!single)
          for (int q = lane; q < Q; q += 32) tf_pop[q] = ptf[(size_t)j * Q + q];
        const int hi_cell = __shfl_sync(kFull, sep, 1);
        if (lane == 0) {
          ps[j] = -CUDART_INF_F;
          sh_live -= 1;
          sh_iters += 1;
          sh_pops += 1;
          sh_j = j;
          sh_d0 = best.d0;
          sh_d1 = best.d1;
          if (single) {
            od[sh_n_out] = best.d0;
            os[sh_n_out] = best.s;
            sh_n_out += 1;
          }
          sh_multi[trip & 1] = !single;
          sh_mid = mid;
          sh_lo = sep;
          sh_hi = mid >= n_docs ? n : hi_cell;
          // free slots after the pop, lowest first: the popped slot among
          // the row's two lowest free slots
          sh_cand[0] = min(f1, j);
          sh_cand[1] = min(max(f1, j), f2);
          sh_stop[trip & 1] = 0;
        }
      }
      __syncwarp();
    }
    __syncthreads();
    if (sh_stop[trip & 1]) break;

    if (sh_multi[trip & 1]) {
      // ---- descent: one warp per (word, endpoint); meanwhile the last warp
      // summarises the popped slot's chunk again
      for (int pr = warp; pr < 2 * Q; pr += kWarps) {
        const int q = pr >> 1, e = pr & 1;
        const int r = wm_s[q] ? wtbc::warp_endpoint_rank(
                                    lv, path[q], e ? sh_hi : sh_lo)
                              : 0;
        if (lane == 0) leaf[e][q] = r;
      }
      if (warp == kHelper)
        pool::warp_summarise(sm, sh_j / kChunk, ps, p0, p1, cap);
      __syncthreads();

      // ---- score (warp 0: lane q forms word q's products, every lane adds
      // them from left to right) and insert
      if (warp == 0) {
        float s1 = 0.f, s2 = 0.f;
        bool all1 = true, all2 = true, any_w = false;
        for (int base = 0; base < Q; base += 32) {
          const int q = base + lane;
          int t1 = 0, t2 = 0;
          float w = 0.f;
          bool m = false;
          if (q < Q) {
            t1 = leaf[1][q] - leaf[0][q];
            t2 = tf_pop[q] - t1;
            w = iw_s[q];
            m = wm_s[q] != 0;
          }
          const float x1 = __fmul_rn(static_cast<float>(t1), w);
          const float x2 = __fmul_rn(static_cast<float>(t2), w);
          const int nq = min(32, Q - base);
          for (int i = 0; i < nq; ++i) {
            s1 = __fadd_rn(s1, __shfl_sync(kFull, x1, i));
            s2 = __fadd_rn(s2, __shfl_sync(kFull, x2, i));
          }
          all1 &= __all_sync(kFull, (t1 > 0) || !m);
          all2 &= __all_sync(kFull, (t2 > 0) || !m);
          any_w |= __any_sync(kFull, m);
        }
        if (lane == 0) {
          const bool ok[2] = {conjunctive ? (all1 && any_w) : (s1 > 0.f),
                              conjunctive ? (all2 && any_w) : (s2 > 0.f)};
          const int d0s[2] = {sh_d0, sh_mid}, d1s[2] = {sh_mid, sh_d1};
          const float ss[2] = {s1, s2};
          int ci = 0;
          for (int c = 0; c < 2; ++c) {
            sh_slot[c] = -1;
            if (!ok[c]) continue;
            const int slot = sh_cand[ci];
            if (slot >= cap) {
              sh_ovf = 1;
              continue;
            }
            ps[slot] = ss[c];
            p0[slot] = d0s[c];
            p1[slot] = d1s[c];
            // the chunk's summary: the new key, one free slot fewer
            pool::note_insert(sm, {ss[c], d0s[c], d1s[c], slot});
            sh_slot[c] = slot;
            ++ci;
            sh_live += 1;
            sh_hw = max(sh_hw, slot + 1);
          }
        }
        __syncwarp();
        for (int c = 0; c < 2; ++c) {
          const int slot = sh_slot[c];
          if (slot < 0) continue;
          for (int q = lane; q < Q; q += 32) {
            const int t1 = leaf[1][q] - leaf[0][q];
            ptf[(size_t)slot * Q + q] = c == 0 ? t1 : tf_pop[q] - t1;
          }
          // an insert takes one of the row's two lowest free slots, hence
          // one of its chunk's: that chunk's pair comes from its mask again
          const int ch = slot / kChunk;
          if (c == 1 && sh_slot[0] >= 0 && sh_slot[0] / kChunk == ch) continue;
          int g1, g2;
          pool::mask_low2(sm, ch, g1, g2);
          if (lane == 0) {
            sm.f1[ch] = g1;
            sm.f2[ch] = g2;
          }
        }
        __syncwarp();
      }
    } else if (warp == 0) {
      // a singleton pop touched one chunk
      pool::warp_summarise(sm, sh_j / kChunk, ps, p0, p1, cap);
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
                         void* summaries, void* stream) {
  if (q < 1 || q > kMaxQ || cap < 1 || summaries == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the summaries: 56 bytes per chunk of 256 slots, in dynamic shared memory
  // while they fit the opt-in, else in the caller's scratch of
  // b * kSummaryInts * n_chunks ints
  bool in_shared = false;
  size_t smem = 0;
  const cudaError_t e = pool::plan_summaries(
      beam_loop_kernel<true>, beam_loop_kernel<false>, 0, cap, &in_shared,
      &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  auto kernel = in_shared ? beam_loop_kernel<true> : beam_loop_kernel<false>;
  kernel<<<b, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(sep_pos), n, n_docs,
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(wmask),
      static_cast<const float*>(idf_w), q, static_cast<float*>(pool_s),
      static_cast<int32_t*>(pool_d0), static_cast<int32_t*>(pool_d1),
      static_cast<int32_t*>(pool_tf), static_cast<int32_t*>(size), cap,
      static_cast<int32_t*>(out_docs),
      static_cast<float*>(out_scores), k, static_cast<int32_t*>(n_out),
      static_cast<int32_t*>(iters), static_cast<int32_t*>(pops),
      static_cast<int32_t*>(overflowed), static_cast<int32_t*>(status),
      conjunctive, max_pops, max_trips, static_cast<int32_t*>(summaries));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* beam_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
