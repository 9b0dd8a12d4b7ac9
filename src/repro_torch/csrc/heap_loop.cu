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
// One trip of a row (16 warps, 512 threads) computes exactly
// kernels/heap_loop.py's heap_trip (the plain loop), with the whole block on
// every step:
//   pop      the nv = min(size, P) lex-greatest slots at once.  They lie in
//            the nv chunks with the lex-greatest summaries (a chunk holding
//            one of them has a best key at least that slot's, and at most
//            nv - 1 slots precede it), so: a block-wide radix select of the
//            nv best chunk summaries over the active chunks (pool.cuh:
//            block_select, 8-bit digits of the key's 128 bits, stopping at
//            the first digit whose bucket is taken whole or holds at most
//            32 keys), then one over those chunks' live slots at or above
//            the chunks' threshold (gathered into shared memory, or read
//            from the pool when more than fit), the nv chosen sorted by
//            rank into the pop order;
//            the slots are freed and each chunk they touched summarised
//            again, one warp a chunk;
//   emit     a popped singleton is the next answer iff it lex-beats every
//            popped multi and the pending top after the pops (whose
//            descendants they bound) — the first multi in pop order is the
//            greatest; emitted ones fill output slots n_out, n_out + 1, ...
//            below k in pop order (warp 0, a ballot per 32 pops), the rest
//            are pushed back;
//   split    every popped multi at mid = (d0 + d1) / 2, its root extent
//            from sep_pos (read beside the popped tf rows);
//   descend  (all warps) the left child's count of every (multi, valid
//            word), one warp a count with its two endpoints' chains side
//            by side (their loads issued together); tf2 = tf − tf1;
//   score    a thread per multi (two warps at P = 64) scores its two
//            children, each product rounded and added from left to right
//            over Q (__fmul_rn / __fadd_rn, the order of
//            core/scoring.dot_q), AND/OR validity as seg_valid;
//   push     up to 3·P lanes, parent-major (left, right, unemitted
//            singleton), ranked by a scan over the pops; the r-th enabled
//            push takes the row's r-th lowest free slot: a block scan of
//            the active chunks' free counts (popcounts of the free masks),
//            a binary search of r over it and a select in the chunk's mask
//            (past the active chunks every slot is free); with no free slot
//            left it is dropped and latches overflowed.  Each touched
//            chunk's summary is then updated by one warp (the pushes' keys
//            against its best, its two lowest free slots from the mask).
// The row's live width nv of each trip goes to widths[row, trip] (the
// caller zeroes the buffer), from which the caller computes the
// reference's pad-waste counter `padded` (core/ranked.py:
// padded_from_widths): it is the one leaf that couples rows.
//
// Shared memory: the chunk summaries as in beam_loop (56 bytes per 256
// slots, in the global scratch when they do not fit); dynamic: the popped
// tf rows and the descents' endpoint ranks, 12·P·Q bytes (48 KB at P = Q =
// 64), and the pop's candidates, 16 bytes each for the P chosen chunks'
// slots up to 4,096 (64 KB from P = 16); static: the select's histograms,
// the scan's offsets, the P popped keys, the multis' extents and scores,
// the 3·P push lanes and the word tables, about 19 KB.
//
// What bounds it on the H100: latency, as beam_loop.  A row's trips are a
// dependent chain and B rows use B of 132 SMs; within a trip the descents
// are up to three memory round trips per count, 16 counts (32 endpoints)
// in flight at a time, and the pops, emission, scoring and pushes are a
// few dozen block barriers and a few reads of the pool.  The design keeps
// each step out of device memory where it can (summaries, keys, tf rows and
// ranks in shared memory) and spreads every step over the block; the
// descents then take the largest part of a trip.
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

// Both endpoint ranks of one word's count, side by side on one warp: at
// each level the two ranks' counter cells and tile loads (wtbc_descent.cuh's
// warp_rank_near, each from the nearer end of its tile) are issued together
// before either is counted, so a count takes up to three memory round
// trips, not six.  (a, b): root positions; every lane gets the leaf ranks
// (0 when cw_len is outside [1, 3]).
__device__ __forceinline__ void warp_endpoint_ranks2(const wtbc::Levels& lv,
                                                     const wtbc::WordPath& w,
                                                     int a, int b, int& ra,
                                                     int& rb) {
  const int lane = threadIdx.x & 31;
  constexpr int kStep = wtbc::kNearLoads * 32 * 16;
  ra = rb = 0;
#pragma unroll
  for (int L = 0; L < wtbc::kLevels; ++L) {
    const wtbc::Level& lvl = lv.lv[L];
    const int pos[2] = {wtbc::clamp_pos(w.off[L], a, lvl.length),
                        wtbc::clamp_pos(w.off[L], b, lvl.length)};
    int lo[2], hi[2], cell[2], cnt[2] = {0, 0};
    bool back[2];
    const uint8_t* tile[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int blk = min(pos[x] / lv.block, lvl.n_blocks - 1);
      const int start = blk * lv.block, cut = pos[x] - start;
      const int valid = min(lv.block, lvl.length - start);
      back[x] = cut > valid / 2;
      lo[x] = back[x] ? cut : 0;
      hi[x] = back[x] ? valid : cut;
      cell[x] = __ldg(lvl.counts + (size_t)(blk + back[x]) * wtbc::kCounterRow +
                      w.byte[L]);
      tile[x] = lvl.data + (size_t)start;
    }
    const uint32_t pat = 0x01010101u * (uint32_t)w.byte[L];
    for (int it = 0;; it += kStep) {  // uniform: both ranges are the warp's
      const int c0[2] = {(lo[0] & ~15) + it, (lo[1] & ~15) + it};
      if (c0[0] >= hi[0] && c0[1] >= hi[1]) break;
      uint4 v[2][wtbc::kNearLoads];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int i = 0; i < wtbc::kNearLoads; ++i) {  // every load first
          const int c = c0[x] + (i * 32 + lane) * 16;
          v[x][i] = c < hi[x]
                        ? __ldg(reinterpret_cast<const uint4*>(tile[x] + c))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int i = 0; i < wtbc::kNearLoads; ++i) {
          const int c = c0[x] + (i * 32 + lane) * 16;
          cnt[x] += wtbc::count16(v[x][i], pat, lo[x] - c, hi[x] - c);
        }
    }
    const int n0 = wtbc::warp_sum(cnt[0]), n1 = wtbc::warp_sum(cnt[1]);
    a = (back[0] ? cell[0] - n0 : cell[0] + n0) - w.base[L];
    b = (back[1] ? cell[1] - n1 : cell[1] + n1) - w.base[L];
    if (w.len == L + 1) {
      ra = a;
      rb = b;
      return;
    }
  }
}

// Pop candidates gathered into dynamic shared memory: the P chosen chunks'
// slots, up to this many; more are read from the pool.
constexpr int kCandMax = 4096;

__host__ __device__ constexpr int cand_cap(int p) {
  return p * pool::kChunk < kCandMax ? p * pool::kChunk : kCandMax;
}

// kShared: the summaries in dynamic shared memory after the 3·P·Q ints of
// tf rows and ranks; else in the row's kSummaryInts * n_chunks ints of
// `summaries`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
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
  using pool::Key4;
  using pool::key4;
  using pool::key4_ge;
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
  const int kCand = cand_cap(P);                     // the pop's candidates
  float* const c_s = reinterpret_cast<float*>(leaf1 + P * Q);
  int* const c_d0 = reinterpret_cast<int*>(c_s + kCand);
  int* const c_d1 = c_d0 + kCand;
  int* const c_i = c_d1 + kCand;
  int* const dw =
      kShared ? c_i + kCand
              : summaries + (size_t)row * pool::kSummaryInts * n_chunks;
  const pool::Summaries sm = pool::summaries_at(dw, n_chunks);
  __shared__ wtbc::WordPath path[kMaxQ];
  __shared__ int wm_s[kMaxQ], qv[kMaxQ];  // the mask; the valid words
  __shared__ float iw_s[kMaxQ];
  __shared__ int warp_live[kWarps], warp_top[kWarps];
  __shared__ pool::SelectScratch selx;
  // the pop: the chosen chunks, the candidate slots, the nv chosen (in any
  // order, then in pop order), each warp's best for the pending top
  __shared__ int sel_ch[kMaxP];
  __shared__ float u_s[kMaxP];
  __shared__ int u_d0[kMaxP], u_d1[kMaxP], u_i[kMaxP];
  __shared__ Key4 u_k[kMaxP];
  __shared__ float wb_s[kWarps];
  __shared__ int wb_d0[kWarps], wb_d1[kWarps], wb_i[kWarps];
  // the trip's popped keys and slots, which ones were emitted, each pop's
  // multi index, and the multis (pop lane, split point, root extent,
  // children's scores and validity bits)
  __shared__ float pk_s[kMaxP];
  __shared__ int pk_d0[kMaxP], pk_d1[kMaxP], pk_j[kMaxP], pk_emit[kMaxP],
      pk_m[kMaxP], pk_lo[kMaxP], pk_hi[kMaxP];
  __shared__ int m_i[kMaxP], m_mid[kMaxP], m_lo[kMaxP], m_hi[kMaxP];
  __shared__ float m_s1[kMaxP], m_s2[kMaxP];
  __shared__ int m_ok[kMaxP];
  // the push lanes: key, where the tf row comes from (src >= 0: the left
  // (2m) or right (2m + 1) child of multi m; src < 0: popped lane -src - 1)
  // and the slot found (-1: dropped); the chunks a trip touched
  __shared__ float pu_s[kMaxPush];
  __shared__ int pu_d0[kMaxPush], pu_d1[kMaxPush], pu_src[kMaxPush],
      pu_slot[kMaxPush];
  __shared__ int ch_list[kMaxP + kMaxPush];
  // the free-count scan: each thread's offset, each warp's total
  __shared__ int toff[kThreads], wsum[kWarps];
  // loop state: written by thread 0 (the counters by atomics) between
  // barriers
  __shared__ int sh_hw, sh_live, sh_n_out, sh_iters, sh_pops, sh_ovf;
  __shared__ int sh_nv, sh_npush, sh_stop, sh_nm, sh_nsel, sh_nc, sh_nu,
      sh_nch, sh_free, sh_nqv;

  // ---- the row's words, and every chunk summarised (warp per chunk)
  for (int q = tid; q < Q; q += kThreads) {
    path[q] = wtbc::load_path(t, __ldg(words + (size_t)row * Q + q));
    wm_s[q] = __ldg(wmask + (size_t)row * Q + q);
    iw_s[q] = __ldg(idf_w + (size_t)row * Q + q);
  }
  if (tid == 0) {
    int nq = 0;
    for (int q = 0; q < Q; ++q)
      if (wm_s[q]) qv[nq++] = q;
    sh_nqv = nq;
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
    if (tid == 0) {
      const bool go = sh_n_out < k && sh_live > 0 &&
                      (max_pops < 0 || sh_pops < max_pops);
      const bool bad = go && trip >= max_trips;  // not for a well-formed pool
      if (bad) status_g[row] = 1;
      sh_stop = !go || bad;
      sh_nv = min(sh_live, P);
      sh_nsel = sh_nc = sh_nu = sh_nch = 0;
    }
    __syncthreads();
    if (sh_stop) break;
    const int nv = sh_nv;
    const int active = pool::active_chunks(sh_hw, n_chunks);

    // ---- pop: the nv best chunks, then the nv best slots in them
    const Key4 kc = pool::block_select<kThreads>(
        [&](int c, Key4& key) {
          const int i = sm.idx[c];
          if (i < 0) return false;
          key = key4(sm.s[c], sm.d0[c], sm.d1[c], i);
          return true;
        },
        active, nv, selx);
    for (int c = tid; c < active; c += kThreads) {
      const int i = sm.idx[c];
      if (i >= 0 && key4_ge(key4(sm.s[c], sm.d0[c], sm.d1[c], i), kc))
        sel_ch[atomicAdd(&sh_nsel, 1)] = c;
    }
    __syncthreads();
    const int n_sel = sh_nsel * kChunk;
    // a live slot of a chosen chunk at or above their threshold (every
    // popped slot is: each chosen chunk's best is at least kc)
    auto slot_key = [&](int u, Key4& key, int& slot) {
      slot = sel_ch[u >> 8] * kChunk + (u & (kChunk - 1));
      if (slot >= cap) return false;
      const float s = ps[slot];
      if (!(s > -CUDART_INF_F)) return false;
      key = key4(s, p0[slot], p1[slot], slot);
      return key4_ge(key, kc);
    };
    for (int u = tid; u < n_sel; u += kThreads) {
      Key4 key;
      int slot;
      if (!slot_key(u, key, slot)) continue;
      const int c = atomicAdd(&sh_nc, 1);
      if (c < kCand) {
        c_s[c] = ps[slot];
        c_d0[c] = p0[slot];
        c_d1[c] = p1[slot];
        c_i[c] = slot;
      }
    }
    __syncthreads();
    const int nc = sh_nc;
    const bool in_smem = nc <= kCand;  // uniform
    Key4 ks;
    if (in_smem) {
      ks = pool::block_select<kThreads>(
          [&](int c, Key4& key) {
            key = key4(c_s[c], c_d0[c], c_d1[c], c_i[c]);
            return true;
          },
          nc, nv, selx);
      for (int c = tid; c < nc; c += kThreads) {
        if (!key4_ge(key4(c_s[c], c_d0[c], c_d1[c], c_i[c]), ks)) continue;
        const int v = atomicAdd(&sh_nu, 1);
        u_s[v] = c_s[c];
        u_d0[v] = c_d0[c];
        u_d1[v] = c_d1[c];
        u_i[v] = c_i[c];
        u_k[v] = key4(c_s[c], c_d0[c], c_d1[c], c_i[c]);
      }
    } else {
      ks = pool::block_select<kThreads>(
          [&](int u, Key4& key) {
            int slot;
            return slot_key(u, key, slot);
          },
          n_sel, nv, selx);
      for (int u = tid; u < n_sel; u += kThreads) {
        Key4 key;
        int slot;
        if (!slot_key(u, key, slot) || !key4_ge(key, ks)) continue;
        const int v = atomicAdd(&sh_nu, 1);
        u_s[v] = ps[slot];
        u_d0[v] = p0[slot];
        u_d1[v] = p1[slot];
        u_i[v] = slot;
        u_k[v] = key;
      }
    }
    __syncthreads();
    // the nv chosen in pop order: each one's rank among them
    if (tid < nv) {
      const Key4 me = u_k[tid];
      int rank = 0;
      for (int v = 0; v < nv; ++v) rank += v != tid && key4_ge(u_k[v], me);
      pk_s[rank] = u_s[tid];
      pk_d0[rank] = u_d0[tid];
      pk_d1[rank] = u_d1[tid];
      pk_j[rank] = u_i[tid];
    }
    __syncthreads();
    // their tf rows; free them; the chunks they touched
    for (int e = tid; e < nv * Q; e += kThreads) {
      const int i = e / Q;
      tf_pop[e] = ptf[(size_t)pk_j[i] * Q + (e - i * Q)];
    }
    if (tid < nv) {
      const int j = pk_j[tid], ch = j / kChunk;
      ps[j] = -CUDART_INF_F;
      // a multi's split point and root extent (read here, beside the tf
      // rows, so their latency overlaps)
      const int d0 = pk_d0[tid], d1 = pk_d1[tid];
      if (d1 - d0 != 1) {
        const int mid = (d0 + d1) / 2;  // d0 >= 0
        pk_lo[tid] = d0 > 0 ? sep_pos[d0 - 1] + 1 : 0;
        pk_hi[tid] = mid >= n_docs ? n : (mid > 0 ? sep_pos[mid - 1] + 1 : 0);
      }
      bool first = true;
      for (int v = 0; v < tid; ++v) first = first && pk_j[v] / kChunk != ch;
      if (first) ch_list[atomicAdd(&sh_nch, 1)] = ch;
    }
    __syncthreads();
    const int n_pch = sh_nch;  // the pushes' chunks follow in ch_list
    for (int c = warp; c < n_pch; c += kWarps)
      pool::warp_summarise(sm, ch_list[c], ps, p0, p1, cap);
    __syncthreads();

    // ---- the pending top after the pops (idx < 0: the pool is empty)
    {
      Key best = {-CUDART_INF_F, 0, 0, -1};
      for (int c = tid; c < active; c += kThreads) {
        const Key o = {sm.s[c], sm.d0[c], sm.d1[c], sm.idx[c]};
        if (pool::precedes(o, best)) best = o;
      }
      pool::warp_reduce_key(best);
      if (lane == 0) {
        wb_s[warp] = best.s;
        wb_d0[warp] = best.d0;
        wb_d1[warp] = best.d1;
        wb_i[warp] = best.idx;
      }
    }
    __syncthreads();

    // ---- emit and split (warp 0, a ballot per 32 pops)
    if (warp == 0) {
      Key top = {-CUDART_INF_F, 0, 0, -1};
      if (lane < kWarps) top = {wb_s[lane], wb_d0[lane], wb_d1[lane], wb_i[lane]};
      pool::warp_reduce_key(top);
      const int n_out0 = sh_n_out;
      // the emission bound: the lex-max of the popped multis (the first in
      // pop order) and top
      const unsigned mu0 =
          __ballot_sync(kFull, lane < nv && pk_d1[lane] - pk_d0[lane] != 1);
      const unsigned mu1 = __ballot_sync(
          kFull, lane + 32 < nv && pk_d1[lane + 32] - pk_d0[lane + 32] != 1);
      const int fm = mu0 ? __ffs(mu0) - 1 : (mu1 ? 31 + __ffs(mu1) : -1);
      bool has = top.idx >= 0;
      float bs = top.s;
      int b0 = top.d0, b1 = top.d1;
      if (fm >= 0 &&
          (!has || lex_gt(pk_s[fm], pk_d0[fm], pk_d1[fm], bs, b0, b1))) {
        has = true;
        bs = pk_s[fm];
        b0 = pk_d0[fm];
        b1 = pk_d1[fm];
      }
      const unsigned lt = (1u << lane) - 1u;
      int ne = 0, nm = 0;
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        const bool in = i < nv;
        const bool multi = in && pk_d1[i] - pk_d0[i] != 1;
        const bool emit = in && !multi &&
                          (!has || lex_gt(pk_s[i], pk_d0[i], pk_d1[i], bs, b0, b1));
        const unsigned em = __ballot_sync(kFull, emit);
        const unsigned mm = __ballot_sync(kFull, multi);
        if (multi) {
          const int m = nm + __popc(mm & lt);
          m_i[m] = i;
          pk_m[i] = m;
        }
        if (in) pk_emit[i] = emit;
        if (emit) {
          const int slot = n_out0 + ne + __popc(em & lt);
          if (slot < k) {
            od[slot] = pk_d0[i];
            os[slot] = pk_s[i];
          }
        }
        ne += __popc(em);
        nm += __popc(mm);
      }
      // the multis' split points and root extents, lane per multi
      for (int m = lane; m < nm; m += 32) {
        const int i = m_i[m];
        m_mid[m] = (pk_d0[i] + pk_d1[i]) / 2;
        m_lo[m] = pk_lo[i];
        m_hi[m] = pk_hi[i];
      }
      if (lane == 0) {
        sh_n_out = min(n_out0 + ne, k);
        sh_live -= nv;
        sh_iters += 1;
        sh_pops += nv;
        sh_nm = nm;
        wrow[trip] = nv;
      }
    }
    __syncthreads();
    const int nm = sh_nm;

    // ---- descent: one warp per (multi, valid word), both endpoints at once
    if (nm > 0) {
      const int nqv = sh_nqv;
      for (int t = warp; t < nm * nqv; t += kWarps) {
        const int m = t / nqv, q = qv[t - m * nqv];
        int r0, r1;
        warp_endpoint_ranks2(lv, path[q], m_lo[m], m_hi[m], r0, r1);
        if (lane == 0) {
          leaf0[m * Q + q] = r0;
          leaf1[m * Q + q] = r1;
        }
      }
      for (int e = tid; e < nm * Q; e += kThreads)  // a masked word counts 0
        if (!wm_s[e % Q]) leaf0[e] = leaf1[e] = 0;
      __syncthreads();
      // ---- score: a thread per multi
      for (int m = tid; m < nm; m += kThreads) {
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
      __syncthreads();
    }

    // ---- the enabled push lanes, parent-major (warp 0: a scan per 32 pops)
    if (warp == 0) {
      int base = 0;
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        int cnt = 0, ok = 0;
        const bool multi = i < nv && pk_d1[i] - pk_d0[i] != 1;
        if (multi) {
          ok = m_ok[pk_m[i]];
          cnt = (ok & 1) + (ok >> 1);
        } else if (i < nv) {
          cnt = !pk_emit[i];
        }
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        int r = base + incl - cnt;
        if (multi) {
          const int m = pk_m[i], mid = m_mid[m];
          if (ok & 1) {
            pu_s[r] = m_s1[m];
            pu_d0[r] = pk_d0[i];
            pu_d1[r] = mid;
            pu_src[r++] = 2 * m;
          }
          if (ok & 2) {
            pu_s[r] = m_s2[m];
            pu_d0[r] = mid;
            pu_d1[r] = pk_d1[i];
            pu_src[r] = 2 * m + 1;
          }
        } else if (cnt) {
          pu_s[r] = pk_s[i];
          pu_d0[r] = pk_d0[i];
          pu_d1[r] = pk_d1[i];
          pu_src[r] = -i - 1;
        }
        base += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) sh_npush = base;
    }
    __syncthreads();
    const int np = sh_npush;
    if (np == 0) continue;  // uniform

    // ---- push: the r-th push takes the r-th lowest free slot
    {
      // each thread's run of active chunks and its free count, scanned
      const int per = (active + kThreads - 1) / kThreads;
      const int c0 = min(tid * per, active), c1 = min(c0 + per, active);
      int f = 0;
      for (int c = c0; c < c1; ++c)
#pragma unroll
        for (int w = 0; w < pool::kMaskWords; ++w)
          f += __popc(sm.free[c * pool::kMaskWords + w]);
      int incl = f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int off = 0;
      for (int w = 0; w < warp; ++w) off += wsum[w];
      toff[tid] = off + incl - f;
      if (tid == kThreads - 1) sh_free = off + incl;
      __syncthreads();
      const int n_free = sh_free;
      for (int r = tid; r < np; r += kThreads) {
        int slot = -1;
        if (r < n_free) {
          int lo = 0, hi = kThreads - 1;  // the last thread whose run starts
          while (lo < hi) {                // at or below r
            const int mid = (lo + hi + 1) >> 1;
            if (toff[mid] <= r) lo = mid; else hi = mid - 1;
          }
          int rr = r - toff[lo];
          for (int c = lo * per;; ++c) {
            int fc = 0;
#pragma unroll
            for (int w = 0; w < pool::kMaskWords; ++w)
              fc += __popc(sm.free[c * pool::kMaskWords + w]);
            if (rr >= fc) {
              rr -= fc;
              continue;
            }
            for (int w = 0;; ++w) {
              const uint32_t fm = sm.free[c * pool::kMaskWords + w];
              const int pc = __popc(fm);
              if (rr < pc) {
                slot = c * kChunk + w * 32 + pool::nth_bit(fm, rr);
                break;
              }
              rr -= pc;
            }
            break;
          }
        } else {  // past the active chunks every slot is free
          const int s2 = active * kChunk + (r - n_free);
          if (s2 < cap) slot = s2;
        }
        pu_slot[r] = slot;
      }
      __syncthreads();
      // write the pushes that landed, and their tf rows
      for (int r = tid; r < np; r += kThreads) {
        const int slot = pu_slot[r];
        if (slot < 0) continue;
        ps[slot] = pu_s[r];
        p0[slot] = pu_d0[r];
        p1[slot] = pu_d1[r];
        atomicAnd(&sm.free[slot / 32], ~(1u << (slot & 31)));
        if (r == 0 || pu_slot[r - 1] / kChunk != slot / kChunk)
          ch_list[atomicAdd(&sh_nch, 1)] = slot / kChunk;
      }
      for (int e = tid; e < np * Q; e += kThreads) {
        const int r = e / Q, q = e - r * Q;
        const int slot = pu_slot[r];
        if (slot < 0) continue;
        const int src = pu_src[r];
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
      // the landed pushes are a prefix of the lanes
      const int nl =
          min(np, n_free + max(0, cap - active * kChunk));
      if (tid == 0) {
        if (nl < np) sh_ovf = 1;
        sh_live += nl;
        if (nl > 0) sh_hw = max(sh_hw, pu_slot[nl - 1] + 1);
      }
      __syncthreads();
      // each chunk a push touched: its pushes' keys against its best, then
      // its two lowest free slots
      const int t0 = sh_nch;
      for (int c = n_pch + warp; c < t0; c += kWarps) {
        const int ch = ch_list[c];
        Key best = {sm.s[ch], sm.d0[ch], sm.d1[ch], sm.idx[ch]};
        for (int r = lane; r < nl; r += 32) {
          const int slot = pu_slot[r];
          if (slot / kChunk != ch) continue;
          const Key o = {pu_s[r], pu_d0[r], pu_d1[r], slot};
          if (pool::precedes(o, best)) best = o;
        }
        pool::warp_reduce_key(best);
        int g1, g2;
        pool::mask_low2(sm, ch, g1, g2);
        if (lane == 0) {
          sm.s[ch] = best.s;
          sm.d0[ch] = best.d0;
          sm.d1[ch] = best.d1;
          sm.idx[ch] = best.idx;
          sm.f1[ch] = g1;
          sm.f2[ch] = g2;
        }
      }
      __syncthreads();
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
  // the popped tf rows, the endpoint ranks and the pop's candidates: 3·P·Q
  // ints and 16 bytes a candidate of dynamic shared memory; the summaries
  // after them while they fit the opt-in, else in the caller's scratch of
  // b * kSummaryInts * n_chunks ints
  bool in_shared = false;
  size_t smem = 0;
  const cudaError_t e = pool::plan_summaries(
      heap_loop_kernel<true>, heap_loop_kernel<false>,
      (size_t)12 * p * q + (size_t)16 * cand_cap(p), cap, &in_shared, &smem);
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
