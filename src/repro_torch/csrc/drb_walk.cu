// drb_walk: WTBC-DRB's whole conjunctive walk, every trip of every row, in
// one launch.
//
// Redesigns K3 (src/repro/kernels/bitmap_rank.py, _kernel: rank1 over the
// packed tf bitmaps) for the H100 on the path that spends it: the DRB `and`
// walk of core/drb.py made one K1 (wavelet_count) and one K3 launch per
// trip from a host loop, around a few hundred plain PyTorch launches (the
// locate's selects, the document search, the top-k sorts, the masks), so
// the card sat idle while K3's own 1.2 us hardly mattered.  Here the loop
// runs on the card: one thread block per row walks its trips until the row
// stops, and the bitmap rank, the count descent and a byte select are
// device functions inside it.  Rows are independent and a stopped row's
// plain trips are exact no-ops, so every row ends in the state the plain
// loop (kernels/drb_walk.py: drb_walk_ref) leaves it in.
//
// One trip of a row (16 warps):
//   pick    (warp 0) the live test (min nd > 0, the row has a valid word and
//           no absent one, it < n_docs + 1, cands < max_pops) and the rarest
//           valid word q* (argmin of nd, lowest q on a tie);
//   locate  one warp per candidate j = p[q*] + 1 + i, i < P, clamped to
//           occ[w*]: from the word's leaf level up to the root, one device
//           select per level (warp_select: a 32-ary search of the byte's
//           counter column, every probe of a round in flight, then one scan
//           of the block with every lane's loads issued before any compare);
//           then the document (a 32-ary search of sep_pos) and its extent
//           and length, read by three lanes at once;
//   count   one warp per endpoint chain (wtbc_descent.cuh:
//           warp_endpoint_rank, K1's device code as it is): the in-document
//           tf of every valid word in every fresh candidate document, and
//           each valid word's occurrences before the last candidate's end;
//   score   one thread per candidate, tf-idf or BM25 in core/scoring.py's
//           order (__fmul_rn / __fadd_rn / __fdiv_rn, left to right over Q
//           from +0); meanwhile one warp per valid word advances its cursor:
//           passed = rank1(off_w + cnt) - rank1(off_w), the second rank
//           computed once per row before the first trip (K3's function: the
//           counter cell and the lane's 32-bit word loaded together);
//   top-k   (only when a candidate is present) a merge of the sorted top-k
//           with the trip's present candidates under (score desc, doc asc),
//           every element placed by counting what precedes it, into the
//           other of two buffers.
//
// Workspace.  The row's per-word tables and cursors, per-candidate values,
// P x Q endpoint ranks and the two top-k buffers (ws_ints) sit in dynamic
// shared memory when the wrapper passes no scratch, else in the device
// scratch it allocates (any P, Q and k the plain loop takes).
//
// What bounds it on the H100: latency.  A trip is a chain of dependent
// memory round trips (per level of the locate: about three search rounds
// and one block scan; the document search: three to four; the descent:
// up to three; one bitmap rank), and a batch has B rows, so at B = 8 eight
// SMs work.  The bytes a trip needs are a few kilobytes.  How a block is
// read matters as much as how often: with each lane reading 128 contiguous
// bytes (every warp load touching 32 cache lines) a select took four times
// as long as with K1's layout of neighbouring lanes on neighbouring 16-byte
// chunks (an H100, scripts/drb_walk_ab.py --stamps).
//
// The byte select, the locate, the document search and the bitmap rank are
// in wtbc_select.cuh and the scoring in drb_score.cuh, shared with the DRB
// bag-of-words kernels (drb_or.cu).
//
// Layout contract (checked by the Python wrapper): levels as for
// wavelet_count; sep_pos, doc_len (n_docs,) int32; occ (V,) int32; bit
// vector words (n_blocks * 32,) 32-bit patterns, counts (n_blocks + 1,)
// int32, bit_off (V + 1,) int32; the row tables (B, Q) int32 / float32;
// the state p, nd (B, Q) int32, top_s (B, k) float32, top_d (B, k) int32
// sorted under (score desc, doc asc), it, cands, padded (B,) int32.
#include <climits>
#include <math_constants.h>

#include "drb_score.cuh"
#include "wtbc_select.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPathInts = sizeof(wtbc::WordPath) / 4;
using drb::Scoring;
using wtbc::warp_locate;
using wtbc::warp_lower_bound;
using wtbc::warp_rank1;

__device__ __forceinline__ bool precedes(float s1, int d1, float s2, int d2) {
  return s1 > s2 || (s1 == s2 && d1 < d2);
}

__host__ __device__ __forceinline__ long long ws_ints(int q, int p, int k) {
  // per word: path, valid, idf, df, off, occ, r0, leaf0, p, nd, clast;
  // per candidate: d, lo, hi, dl, present, score; per (candidate, word):
  // two endpoint ranks; two top-k buffers of (score, doc)
  return (long long)q * (kPathInts + 10) + 6LL * p + 2LL * p * q + 4LL * k;
}

__global__ void __launch_bounds__(kThreads)
drb_walk_kernel(wtbc::Levels lv, wtbc::WordTables t,
                const int32_t* __restrict__ sep_pos,
                const int32_t* __restrict__ doc_len,
                const int32_t* __restrict__ occ_g, int n, int n_docs,
                const uint32_t* __restrict__ bv_words,
                const int32_t* __restrict__ bv_counts, int bv_blocks,
                int n_bits, const int32_t* __restrict__ bit_off,
                const int32_t* __restrict__ words,
                const int32_t* __restrict__ valid_g,
                const float* __restrict__ idf_g,
                const int32_t* __restrict__ df_g,
                const int32_t* __restrict__ row_ok, int Q, Scoring sc, int P,
                int k, int max_pops, int32_t* p_g, int32_t* nd_g,
                float* top_s_g, int32_t* top_d_g, int32_t* it_g,
                int32_t* cands_g, int32_t* padded_g, int32_t* scratch) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ int4 dyn[];
  int* const ws = scratch ? scratch + (size_t)row * ws_ints(Q, P, k)
                          : reinterpret_cast<int*>(dyn);
  wtbc::WordPath* const path = reinterpret_cast<wtbc::WordPath*>(ws);
  int* const valid = ws + (size_t)Q * kPathInts;
  float* const idf = reinterpret_cast<float*>(valid + Q);
  int* const df = valid + 2 * Q;
  int* const off = valid + 3 * Q;
  int* const occ = valid + 4 * Q;
  int* const r0 = valid + 5 * Q;
  int* const leaf0 = valid + 6 * Q;
  int* const pq = valid + 7 * Q;
  int* const nd = valid + 8 * Q;
  int* const clast = valid + 9 * Q;
  int* const cd = valid + 10 * Q;
  int* const clo = cd + P;
  int* const chi = cd + 2 * P;
  int* const cdl = cd + 3 * P;
  int* const cpres = cd + 4 * P;
  float* const cscore = reinterpret_cast<float*>(cd + 5 * P);
  int* const le0 = cd + 6 * P;
  int* const le1 = le0 + (size_t)P * Q;
  float* const ts = reinterpret_cast<float*>(le1 + (size_t)P * Q);  // [2][k]
  int* const td = le1 + (size_t)P * Q + 2 * k;                      // [2][k]

  __shared__ int sh_stop, sh_q, sh_j0, sh_nv, sh_cur, sh_ok;
  __shared__ int sh_it, sh_cands, sh_padded;

  // ---- the row's tables and state
  const size_t rq = (size_t)row * Q, rk = (size_t)row * k;
  for (int q = tid; q < Q; q += kThreads) {
    const int w = __ldg(words + rq + q);
    path[q] = wtbc::load_path(t, w);
    valid[q] = __ldg(valid_g + rq + q);
    idf[q] = __ldg(idf_g + rq + q);
    df[q] = __ldg(df_g + rq + q);
    off[q] = __ldg(bit_off + w);
    occ[q] = __ldg(occ_g + w);
    pq[q] = p_g[rq + q];
    nd[q] = nd_g[rq + q];
  }
  for (int i = tid; i < k; i += kThreads) {
    ts[i] = top_s_g[rk + i];
    td[i] = top_d_g[rk + i];
  }
  if (tid == 0) {
    sh_it = it_g[row];
    sh_cands = cands_g[row];
    sh_padded = padded_g[row];
    sh_ok = __ldg(row_ok + row);
    sh_cur = 0;
  }
  __syncthreads();
  // constants of the walk, per valid word: rank1 at its bitmap's start, and
  // its leaf rank at root position 0 (a count from 0 subtracts it)
  for (int task = warp; task < 2 * Q; task += kWarps) {
    const int q = task >> 1;
    if (!valid[q]) continue;
    if (task & 1) {
      const int r = warp_rank1(bv_words, bv_counts, bv_blocks, n_bits, off[q]);
      if (lane == 0) r0[q] = r;
    } else {
      const int r = wtbc::warp_endpoint_rank(lv, path[q], 0);
      if (lane == 0) leaf0[q] = r;
    }
  }
  __syncthreads();

  for (;;) {
    // ---- pick: the live test and the rarest valid word (warp 0)
    if (warp == 0) {
      int mn = INT_MAX, best = INT_MAX, bq = 0;
      for (int q = lane; q < Q; q += 32) {  // a lane's q ascend
        const int x = nd[q];
        mn = min(mn, x);
        const int y = valid[q] ? x : INT_MAX;
        if (y < best) {
          best = y;
          bq = q;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mn = min(mn, __shfl_xor_sync(kFull, mn, o));
        const int ob = __shfl_xor_sync(kFull, best, o);
        const int oq = __shfl_xor_sync(kFull, bq, o);
        if (ob < best || (ob == best && oq < bq)) {
          best = ob;
          bq = oq;
        }
      }
      if (lane == 0) {
        const bool live = mn > 0 && sh_ok && sh_it < n_docs + 1 &&
                          (max_pops < 0 || sh_cands < max_pops);
        sh_stop = !live;
        if (live) {
          const int j0 = pq[bq];
          sh_q = bq;
          sh_j0 = j0;
          sh_nv = min(P, max(occ[bq] - j0, 0));  // candidates j <= occ
        }
      }
    }
    __syncthreads();
    if (sh_stop) break;
    const int qs = sh_q, j0 = sh_j0, nv = sh_nv;

    // ---- locate each candidate, then its document (a warp each)
    for (int i = warp; i < nv; i += kWarps) {
      const int pos = warp_locate(lv, path[qs], j0 + 1 + i);
      const int d = warp_lower_bound(sep_pos, 1, n_docs, pos);
      const int dc = min(max(d, 0), n_docs - 1);
      int x = 0;  // its extent and length, three lanes at once
      if (lane == 0) x = __ldg(sep_pos + min(max(d - 1, 0), n_docs - 1));
      if (lane == 1) x = __ldg(sep_pos + dc);
      if (lane == 2) x = __ldg(doc_len + dc);
      const int s_lo = __shfl_sync(kFull, x, 0);
      const int s_hi = __shfl_sync(kFull, x, 1);
      const int dl = __shfl_sync(kFull, x, 2);
      if (lane == 0) {
        cd[i] = d;
        clo[i] = d == 0 ? 0 : s_lo + 1;
        chi[i] = d + 1 >= n_docs ? n : s_hi + 1;
        cdl[i] = dl;
      }
    }
    __syncthreads();

    // ---- counts: one warp per endpoint chain.  In-document tfs only for
    // fresh candidate documents (a repeated one is never present)
    const int hi_last = nv > 0 ? chi[nv - 1] : (n_docs <= 0 ? n : 0);
    const int n_doc_tasks = 2 * nv * Q;
    for (int task = warp; task < n_doc_tasks + Q; task += kWarps) {
      if (task < n_doc_tasks) {
        const int i = task / (2 * Q), r = task - i * 2 * Q;
        const int q = r >> 1, e = r & 1;
        if (!valid[q] || (i > 0 && cd[i] == cd[i - 1])) continue;
        const int a = wtbc::warp_endpoint_rank(lv, path[q], e ? chi[i] : clo[i]);
        if (lane == 0) (e ? le1 : le0)[(size_t)i * Q + q] = a;
      } else {
        const int q = task - n_doc_tasks;
        if (!valid[q]) continue;
        const int a = wtbc::warp_endpoint_rank(lv, path[q], hi_last);
        if (lane == 0) clast[q] = a - leaf0[q];
      }
    }
    __syncthreads();

    // ---- score (a thread per candidate) and cursors (a warp per word)
    int mine = 0;
    for (int i = tid; i < nv; i += kThreads) {
      const bool fresh = i == 0 || cd[i] != cd[i - 1];
      bool present = fresh;
      float acc = 0.f;
      if (fresh) {
        const float norm =
            sc.bm25 ? drb::doc_norm(sc, *sc.avg_dl, cdl[i]) : 0.f;
        for (int q = 0; q < Q; ++q) {
          const size_t at = (size_t)i * Q + q;
          const int tf = valid[q] ? le1[at] - le0[at] : 0;
          present = present && (tf > 0 || !valid[q]);
          acc = drb::add_part(acc, drb::word_part(sc, tf, norm), idf[q]);
        }
      }
      cpres[i] = present;
      cscore[i] = acc;
      mine |= present;
    }
    if (tid == 0) {
      int fresh = nv > 0;
      for (int i = 1; i < nv; ++i) fresh += cd[i] != cd[i - 1];
      sh_it += 1;
      sh_cands += fresh;
      sh_padded += P - nv;
    }
    for (int q = kWarps - 1 - warp; q < Q; q += kWarps) {
      if (!valid[q]) {
        if (lane == 0) nd[q] = INT_MAX;
        continue;
      }
      const int r = warp_rank1(bv_words, bv_counts, bv_blocks, n_bits,
                               off[q] + clast[q]);
      if (lane == 0) {
        nd[q] = df[q] - (r - r0[q]);
        pq[q] = clast[q];
      }
    }
    if (!__syncthreads_or(mine)) continue;

    // ---- top-k: merge the present candidates into the other buffer
    const int cur = sh_cur;
    const float* os = ts + cur * k;
    const int* od = td + cur * k;
    float* ns = ts + (cur ^ 1) * k;
    int* nd2 = td + (cur ^ 1) * k;
    for (int i = tid; i < k; i += kThreads) {
      const float s = os[i];
      const int d = od[i];
      int at = i;
      for (int c = 0; c < nv; ++c)
        at += cpres[c] && precedes(cscore[c], cd[c], s, d);
      if (at < k) {
        ns[at] = s;
        nd2[at] = d;
      }
    }
    for (int c = tid; c < nv; c += kThreads) {
      if (!cpres[c]) continue;
      const float s = cscore[c];
      const int d = cd[c];
      int lo = 0, hi = k;  // the old entries before it: a prefix
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (precedes(os[mid], od[mid], s, d)) lo = mid + 1;
        else hi = mid;
      }
      int at = lo;
      for (int c2 = 0; c2 < nv; ++c2)
        at += cpres[c2] && precedes(cscore[c2], cd[c2], s, d);
      if (at < k) {
        ns[at] = s;
        nd2[at] = d;
      }
    }
    __syncthreads();
    if (tid == 0) sh_cur = cur ^ 1;
  }

  // ---- the row's state back
  for (int q = tid; q < Q; q += kThreads) {
    p_g[rq + q] = pq[q];
    nd_g[rq + q] = nd[q];
  }
  const int cur = sh_cur;
  for (int i = tid; i < k; i += kThreads) {
    top_s_g[rk + i] = ts[cur * k + i];
    top_d_g[rk + i] = td[cur * k + i];
  }
  if (tid == 0) {
    it_g[row] = sh_it;
    cands_g[row] = sh_cands;
    padded_g[row] = sh_padded;
  }
}

}  // namespace

extern "C" int drb_walk(const void* d0, const void* c0, int nb0, int len0,
                        const void* d1, const void* c1, int nb1, int len1,
                        const void* d2, const void* c2, int nb2, int len2,
                        int block, const void* cw, const void* cw_len,
                        const void* node_off, const void* base_rank,
                        const void* sep_pos, const void* doc_len,
                        const void* occ, int n, int n_docs,
                        const void* bv_words, const void* bv_counts,
                        int bv_blocks, int n_bits, const void* bit_off,
                        const void* words, const void* valid,
                        const void* idf_w, const void* df_w,
                        const void* row_ok, int q, int bm25,
                        const void* avg_dl, float one_minus_b, float b,
                        float k1_plus_1, float k1, int p, int k, int max_pops,
                        void* p_s, void* nd_s, void* top_s, void* top_d,
                        void* it, void* cands, void* padded, int ws_bytes,
                        void* scratch, int rows, void* stream) {
  // ws_bytes: the wrapper's size of a row's workspace, which must be ours
  if (q < 1 || p < 1 || k < 0 || rows < 1 || n_docs < 1 ||
      (bm25 && avg_dl == nullptr) || ws_bytes != 4 * ws_ints(q, p, k))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)ws_bytes;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncGetAttributes(&attr, drb_walk_kernel);
    if (smem + attr.sharedSizeBytes > (size_t)optin)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          drb_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  const Scoring sc = {bm25, static_cast<const float*>(avg_dl), one_minus_b, b,
                      k1_plus_1, k1};
  drb_walk_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, t, static_cast<const int32_t*>(sep_pos),
      static_cast<const int32_t*>(doc_len), static_cast<const int32_t*>(occ),
      n, n_docs, static_cast<const uint32_t*>(bv_words),
      static_cast<const int32_t*>(bv_counts), bv_blocks, n_bits,
      static_cast<const int32_t*>(bit_off), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(valid), static_cast<const float*>(idf_w),
      static_cast<const int32_t*>(df_w), static_cast<const int32_t*>(row_ok),
      q, sc, p, k, max_pops, static_cast<int32_t*>(p_s),
      static_cast<int32_t*>(nd_s), static_cast<float*>(top_s),
      static_cast<int32_t*>(top_d), static_cast<int32_t*>(it),
      static_cast<int32_t*>(cands), static_cast<int32_t*>(padded),
      static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* drb_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
