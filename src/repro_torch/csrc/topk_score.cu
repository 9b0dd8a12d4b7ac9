// scored_topk: fused candidate scoring and top-k, merged in the launch.
//
// Replaces the Pallas kernel src/repro/kernels/topk_score.py (_kernel): for
// one query (d,) against C candidate rows (C, d), the k best (score, row)
// pairs of cands @ query.  The reference reduces each tile of T rows to its
// k best and merges the (n_tiles, k) partials outside the kernel; here the
// merge is inside the one launch.  A batch of B queries, each with its own
// (C, d) candidates, runs in the same launch: the grid's second dimension is
// the query.
//
// What bounds it on the H100: bytes.  The candidates are read once (C * d *
// element size: 512 MB at C = 10^6, d = 128, float32) and only (B, k) pairs
// are written.  The design:
//
// * Staging.  A persistent grid (gx blocks per query, one block of 8 warps
//   per SM) walks the query's rows in row blocks of rs rows; each warp
//   takes every (gx * 8)-th row block and copies it into its own ring of
//   kStages stages in shared memory with cp.async (16 bytes a lane,
//   neighbouring lanes on neighbouring addresses: a row block is one
//   contiguous span), kStages - 1 stages ahead of the one it scores, so the
//   loads overlap the scoring.  A row of u 16-byte units is stored at a
//   stride of sp units, sp odd, so the 8 lanes of a 16-byte shared-memory
//   phase, reading 8 consecutive rows at one unit, hit 8 different bank
//   groups: no bank conflict (the padded-stride choice; no TMA swizzle).
//   Rows wider than a stage are staged in slices of su units, the running
//   sum kept in a register between slices.  The row_ok mask bytes of a
//   stage's rows ride in the same cp.async group.
// * Float contract.  Lane j scores row j of the stage, left to right over d
//   with __fmul_rn / __fadd_rn (no FMA contraction), so the plain version (a
//   loop over d, each product rounded and then added) agrees bitwise.
// * k kept during the pass.  Each warp keeps its k best as it goes; a row
//   that is not better than the warp's current k-th (score desc, row asc)
//   is dropped at once.  k <= 32: a sorted list in registers, lane i the
//   i-th best; up to two rows of a round that pass are inserted one by one
//   (ballot and shuffle), more are sorted by a bitonic network over the
//   lanes and merged by rank (each entry's index plus the other list's
//   entries better than it).  k > 32: a sorted list of k in device scratch
//   (two buffers per warp) with a 256-entry buffer in shared memory: rows
//   that pass are appended there, and a full buffer is sorted (bitonic)
//   and merged into the list by rank.  One kernel body, instantiated for
//   the two lists and for staged or unaligned rows (four in all); the
//   element type is a run-time switch per 16-byte unit, so the body is not
//   compiled once per type.
// * Merge in the launch.  A block merges its warps' lists into warp 0's
//   (register lists: a tree of pairwise rank merges, three levels), writes
//   it as the block's partial and takes a ticket (atomicInc, which wraps
//   the per-query counter back to 0 for the next launch); the last block
//   of a query merges the gx partials — a partial whose best entry cannot
//   enter is skipped — and writes (k,) scores and rows.  No further launch
//   and no host merge.
//
// Semantics: ties go to the lower row; rows past C never compete, nor rows
// whose optional row_ok byte is 0; a slot no eligible row fills is (-inf,
// INT32_MAX); a NaN score never competes.
//
// Layout contract (checked by the Python wrapper, which plans rs, su, sp,
// nslice and gx: kernels/topk_score.py:launch_plan): cands contiguous (B, C,
// d) float32 / float16 / bfloat16; query (B, d) float32; row_ok null or (B,
// C) uint8; vec: d * element size a multiple of 16 and cands 16-byte
// aligned; scratch part (B, gx, k), lists (k > 32 only) (B, gx, 8, 2, k);
// tickets (B,) uint32, zero before the first launch; out (B, k).
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kBuf = 256;        // k > 32: shared candidates per warp
constexpr unsigned kFull = 0xffffffffu;

// Element types (the wrapper's dtype codes), read as float32.
enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float elem(const unsigned char* p, int i,
                                      int dtype) {
  if (dtype == kF32) return reinterpret_cast<const float*>(p)[i];
  if (dtype == kF16)
    return __half2float(reinterpret_cast<const __half*>(p)[i]);
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// a + the products of a 16-byte unit of dtype kD with q, left to right,
// each rounded and then added (no FMA contraction)
template <int kD>
__device__ __forceinline__ float dot_unit(float a, const uint4& v,
                                          const float* q) {
  constexpr int per = kD == kF32 ? 4 : 8;
  const unsigned char* e = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
  for (int i = 0; i < per; ++i)
    a = __fadd_rn(a, __fmul_rn(elem(e, i, kD), __ldg(q + i)));
  return a;
}

// (s, r) precedes (bs, br) in the order (score desc, row asc)
__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// k <= 32: the warp's k best in registers, lane i the i-th best; tmp_s /
// tmp_r: the warp's 32-entry shared scratch for merges.
struct RegList {
  float s, ts;    // this lane's entry; the k-th best (every lane)
  int r, tr, k;
  float* tmp_s;
  int* tmp_r;

  __device__ void init(int k_, float* t_s, int* t_r) {
    k = k_;
    tmp_s = t_s;
    tmp_r = t_r;
    s = ts = -INFINITY;
    r = tr = INT_MAX;
  }
  // Merge a sorted list held one entry a lane (lane j: its j-th best,
  // (-inf, INT_MAX) past its end): each entry's place in the union is its
  // index plus the other list's entries better than it (rows are distinct,
  // so only padding entries tie, and they hold the same value).
  __device__ void merge(float bs, int br) {
    const int lane = threadIdx.x & 31;
    int ra = lane, rb = lane;
    for (int t = 0; t < k; ++t) {
      const float as_ = __shfl_sync(kFull, s, t);
      const int ar = __shfl_sync(kFull, r, t);
      const float bt = __shfl_sync(kFull, bs, t);
      const int btr = __shfl_sync(kFull, br, t);
      ra += better(bt, btr, s, r);
      rb += better(as_, ar, bs, br);
    }
    if (lane < k && ra < k) { tmp_s[ra] = s; tmp_r[ra] = r; }
    if (lane < k && rb < k) { tmp_s[rb] = bs; tmp_r[rb] = br; }
    __syncwarp();
    if (lane < k) { s = tmp_s[lane]; r = tmp_r[lane]; }
    __syncwarp();
    ts = __shfl_sync(kFull, s, k - 1);
    tr = __shfl_sync(kFull, r, k - 1);
  }
  // Each lane offers (cs, cr) if ok; every lane of the warp calls it.  A
  // few rows that pass are inserted one by one; more are sorted (a bitonic
  // network over the lanes) and merged.
  __device__ void offer(float cs, int cr, bool ok) {
    const int lane = threadIdx.x & 31;
    const bool pass = ok && better(cs, cr, ts, tr);
    unsigned m = __ballot_sync(kFull, pass);
    if (__popc(m) > 2) {
      float xs = pass ? cs : -INFINITY;
      int xr = pass ? cr : INT_MAX;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const float os = __shfl_xor_sync(kFull, xs, stride);
          const int orr = __shfl_xor_sync(kFull, xr, stride);
          const bool keep_best = ((lane & stride) == 0) == ((lane & size) == 0);
          if (keep_best ? better(os, orr, xs, xr) : better(xs, xr, os, orr)) {
            xs = os;
            xr = orr;
          }
        }
      }
      merge(xs, xr);
      return;
    }
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float xs = __shfl_sync(kFull, cs, src);
      const int xr = __shfl_sync(kFull, cr, src);
      if (!better(xs, xr, ts, tr)) continue;        // uniform
      const int pos =
          __popc(__ballot_sync(kFull, lane < k && better(s, r, xs, xr)));
      const float us = __shfl_up_sync(kFull, s, 1);
      const int ur = __shfl_up_sync(kFull, r, 1);
      if (lane > pos) { s = us; r = ur; }
      else if (lane == pos) { s = xs; r = xr; }
      ts = __shfl_sync(kFull, s, k - 1);
      tr = __shfl_sync(kFull, r, k - 1);
    }
  }
  __device__ void flush() {}
  __device__ int size() const { return k; }   // entries past the real ones
                                              // are (-inf, INT_MAX)
  __device__ void entry(int i, float& es, int& er) const {
    // lane i's entry, read by lane i (i == lane)
    es = s;
    er = r;
  }
};

// k > 32: the warp's k best in device scratch (two buffers of k, the
// current one sorted best first, n entries), rows that pass appended to a
// shared-memory buffer and merged in when it fills.
struct BigList {
  float* gs[2];
  int* gr[2];
  float* bs;      // shared buffer (kBuf)
  int* br;
  float ts;
  int tr, k, n, nb, cur;

  __device__ void init(int k_, float* s0, int* r0, float* b_s, int* b_r) {
    k = k_;
    gs[0] = s0; gs[1] = s0 + k; gr[0] = r0; gr[1] = r0 + k;
    bs = b_s; br = b_r;
    ts = -INFINITY; tr = INT_MAX;
    n = nb = cur = 0;
  }
  __device__ void offer(float cs, int cr, bool ok) {
    const int lane = threadIdx.x & 31;
    const bool pass = ok && better(cs, cr, ts, tr);
    const unsigned m = __ballot_sync(kFull, pass);
    if (pass) {
      const int i = nb + __popc(m & ((1u << lane) - 1u));
      bs[i] = cs;
      br[i] = cr;
    }
    nb += __popc(m);
    if (nb > kBuf - 32) flush();
  }
  // entries of a sorted (es, er)[0, len) that are better than (xs, xr)
  __device__ static int count_better(const float* es, const int* er, int len,
                                     float xs, int xr, bool global) {
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float ms = global ? __ldcg(es + mid) : es[mid];
      const int mr = global ? __ldcg(er + mid) : er[mid];
      if (better(ms, mr, xs, xr)) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
  __device__ void flush() {
    if (nb == 0) return;
    const int lane = threadIdx.x & 31;
    int P = 32;
    while (P < nb) P <<= 1;
    for (int i = nb + lane; i < P; i += 32) {   // sentinels to a power of 2
      bs[i] = -INFINITY;
      br[i] = INT_MAX;
    }
    __syncwarp();
    for (int size = 2; size <= P; size <<= 1) {       // bitonic, best first
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < P / 2; t += 32) {
          const int i = 2 * stride * (t / stride) + (t % stride);
          const int j = i + stride;
          const bool first_best = (i & size) == 0;
          const float a = bs[i], b = bs[j];
          const int ra = br[i], rb = br[j];
          if (first_best ? better(b, rb, a, ra) : better(a, ra, b, rb)) {
            bs[i] = b; br[i] = rb; bs[j] = a; br[j] = ra;
          }
        }
        __syncwarp();
      }
    }
    // rank placement: every entry's place in the merged order
    const float* as = gs[cur];
    const int* ar = gr[cur];
    float* os = gs[cur ^ 1];
    int* orr = gr[cur ^ 1];
    for (int i = lane; i < n; i += 32) {
      const float xs = __ldcg(as + i);
      const int xr = __ldcg(ar + i);
      const int pos = i + count_better(bs, br, nb, xs, xr, false);
      if (pos < k) { os[pos] = xs; orr[pos] = xr; }
    }
    for (int j = lane; j < nb; j += 32) {
      const float xs = bs[j];
      const int xr = br[j];
      const int pos = j + count_better(as, ar, n, xs, xr, true);
      if (pos < k) { os[pos] = xs; orr[pos] = xr; }
    }
    __threadfence();
    __syncwarp();
    n = min(k, n + nb);
    nb = 0;
    cur ^= 1;
    if (n == k) {
      ts = __ldcg(gs[cur] + k - 1);
      tr = __ldcg(gr[cur] + k - 1);
    }
  }
  __device__ int size() const { return n; }
  __device__ void entry(int i, float& es, int& er) const {
    es = __ldcg(gs[cur] + i);
    er = __ldcg(gr[cur] + i);
  }
};

// Offer a sorted list (es, er)[0, len), best first, to a buffered list
// from every lane of the warp, 32 entries a round, until a round has no
// entry better than the list's k-th.
__device__ void consume(BigList& list, const float* es, const int* er,
                        int len) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < len; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < len;
    const float xs = in ? __ldcg(es + i) : -INFINITY;
    const int xr = in ? __ldcg(er + i) : INT_MAX;
    const bool pass = in && better(xs, xr, list.ts, list.tr);
    if (!__any_sync(kFull, pass)) break;   // the rest are worse still
    list.offer(xs, xr, in);
  }
}

// Merge the block's warp lists into warp 0's.  Register lists: a tree of
// pairwise merges through the shared exchange xs / xr (kWarps * 32
// entries); buffered lists: warp 0 consumes the others' (sizes xn, device
// lists gls / glr).  Every thread calls it.
template <class List>
__device__ void merge_warps(List& list, float* xs, int* xr, int* xn,
                            float** gls, int** glr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  list.flush();
  if constexpr (std::is_same<List, RegList>::value) {
    for (int step = 1; step < kWarps; step <<= 1) {
      if (warp % (2 * step) == step) {
        xs[warp * 32 + lane] = list.s;
        xr[warp * 32 + lane] = list.r;
      }
      __syncthreads();
      if (warp % (2 * step) == 0) {
        const int o = (warp + step) * 32 + lane;
        const bool in = lane < list.k;
        list.merge(in ? xs[o] : -INFINITY, in ? xr[o] : INT_MAX);
      }
      __syncthreads();
    }
  } else {
    if (lane == 0) {
      xn[warp] = list.size();
      gls[warp] = list.gs[list.cur];
      glr[warp] = list.gr[list.cur];
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < kWarps; ++w) consume(list, gls[w], glr[w], xn[w]);
      list.flush();
    }
    __syncthreads();
  }
}

// warp 0: the block's list as k entries, (-inf, INT_MAX) past its size
template <class List>
__device__ void write_list(const List& list, float* os, int* orr) {
  const int lane = threadIdx.x & 31;
  const int n = list.size();
  for (int i = lane; i < list.k; i += 32) {
    float s = -INFINITY;
    int r = INT_MAX;
    if (i < n) list.entry(i, s, r);
    os[i] = s;
    orr[i] = r;
  }
}

struct Plan {
  int rs, su, sp, nslice, gx;
};

template <bool kVec, bool kSmall>
__global__ void __launch_bounds__(kThreads)
scored_topk_kernel(const unsigned char* __restrict__ cands, int dtype,
                   const float* __restrict__ query,
                   const uint8_t* __restrict__ row_ok, int C, int d, int k,
                   Plan pl, float* __restrict__ part_s,
                   int32_t* __restrict__ part_i, float* __restrict__ list_s,
                   int32_t* __restrict__ list_i, unsigned* tickets,
                   float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  using List = typename std::conditional<kSmall, RegList, BigList>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float x_s[kWarps * 32], m_s[kWarps * 32];
  __shared__ int x_r[kWarps * 32], m_r[kWarps * 32], x_n[kWarps];
  __shared__ float* x_gs[kWarps];
  __shared__ int* x_gr[kWarps];
  __shared__ bool s_last;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, b = blockIdx.y, gx = pl.gx;
  const int es = dtype == kF32 ? 4 : 2;        // bytes per element
  cands += (size_t)b * C * d * es;
  query += (size_t)b * d;
  if (row_ok != nullptr) row_ok += (size_t)b * C;

  // this warp's shared memory: kStages stages, their mask windows, and the
  // candidate buffer of a k > 32 list
  const int per = 16 / es;                     // elements per 16 bytes
  const int upr = kVec ? d / per : 0;          // 16-byte units per row
  const int stage_bytes = kVec ? pl.rs * pl.sp * 16 : 0;
  const int mask_bytes = (kVec && row_ok != nullptr) ? (pl.rs + 31) & ~15 : 0;
  const int warp_bytes = kStages * (stage_bytes + mask_bytes) +
                         (kSmall ? 0 : kBuf * 8);
  unsigned char* mine = smem + (size_t)warp * warp_bytes;
  unsigned char* masks = mine + kStages * stage_bytes;

  List list;
  const size_t wslot = ((size_t)b * gx + bx) * kWarps + warp;
  if constexpr (kSmall) {
    list.init(k, m_s + warp * 32, m_r + warp * 32);
  } else {
    float* buf = reinterpret_cast<float*>(masks + kStages * mask_bytes);
    list.init(k, list_s + wslot * 2 * k, list_i + wslot * 2 * k, buf,
              reinterpret_cast<int*>(buf + kBuf));
  }

  const int n_rb = (C + pl.rs - 1) / pl.rs;
  const int wid = bx * kWarps + warp, wstep = gx * kWarps;
  const int my_rb = wid < n_rb ? (n_rb - 1 - wid) / wstep + 1 : 0;
  const int n_st = my_rb * pl.nslice;

  auto stage_in = [&](int st) {
    const int rb = wid + (st / pl.nslice) * wstep, sl = st % pl.nslice;
    const int row0 = rb * pl.rs, nrows = min(pl.rs, C - row0);
    const int u0 = sl * pl.su, uw = min(pl.su, upr - u0);
    unsigned char* slot = mine + (st % kStages) * stage_bytes;
    const int pieces = nrows * uw;
    if (pieces > 0) {
      const int dq = 32 / uw, dr = 32 % uw;
      int row = lane / uw, unit = lane % uw;
      for (int p = lane; p < pieces; p += 32) {
        cp_async16(slot + ((size_t)row * pl.sp + unit) * 16,
                   cands + ((size_t)(row0 + row) * upr + u0 + unit) * 16);
        unit += dr;
        row += dq;
        if (unit >= uw) { unit -= uw; ++row; }
      }
    }
    if (mask_bytes && sl == pl.nslice - 1) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(row_ok + row0);
      const uintptr_t a0 = a & ~uintptr_t(15);
      const int units = (int)((a + nrows - a0 + 15) >> 4);
      unsigned char* ms = masks + (st % kStages) * mask_bytes;
      for (int u = lane; u < units; u += 32)
        cp_async16(ms + 16 * u, reinterpret_cast<const void*>(a0 + 16 * u));
    }
  };

  float acc = 0.0f;
  auto score = [&](int st) {
    const int rb = wid + (st / pl.nslice) * wstep, sl = st % pl.nslice;
    const int row0 = rb * pl.rs, nrows = min(pl.rs, C - row0);
    const int u0 = sl * pl.su, uw = min(pl.su, upr - u0);
    const uint4* slot =
        reinterpret_cast<const uint4*>(mine + (st % kStages) * stage_bytes);
    const unsigned char* ms = masks + (st % kStages) * mask_bytes +
        (reinterpret_cast<uintptr_t>(row_ok + row0) & 15);
    const float* q = query + u0 * per;
    for (int j0 = 0; j0 < nrows; j0 += 32) {     // uniform
      const int j = j0 + lane;
      float a = sl == 0 ? 0.0f : acc;
      if (j < nrows) {
        const uint4* rowp = slot + (size_t)j * pl.sp;
        if (dtype == kF32)
          for (int u = 0; u < uw; ++u)
            a = dot_unit<kF32>(a, rowp[u], q + u * 4);
        else if (dtype == kF16)
          for (int u = 0; u < uw; ++u)
            a = dot_unit<kF16>(a, rowp[u], q + u * 8);
        else
          for (int u = 0; u < uw; ++u)
            a = dot_unit<kBF16>(a, rowp[u], q + u * 8);
      }
      acc = a;
      if (sl == pl.nslice - 1)
        list.offer(a, row0 + j,
                   j < nrows && (row_ok == nullptr || ms[j] != 0));
    }
  };

  if constexpr (kVec) {
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < n_st) stage_in(p);
      cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      if (st + kStages - 1 < n_st) stage_in(st + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      score(st);
      __syncwarp();                        // before the slot is refilled
    }
    cp_async_wait<0>();
  } else {
    // rows not 16-byte aligned: each lane reads its row from device memory
    for (int st = 0; st < n_st; ++st) {
      const int row0 = (wid + st * wstep) * pl.rs;
      const int nrows = min(pl.rs, C - row0);
      for (int j0 = 0; j0 < nrows; j0 += 32) {
        const int j = j0 + lane;
        float a = 0.0f;
        if (j < nrows) {
          const unsigned char* rowp = cands + (size_t)(row0 + j) * d * es;
          for (int i = 0; i < d; ++i)
            a = __fadd_rn(a, __fmul_rn(elem(rowp, i, dtype),
                                       __ldg(query + i)));
        }
        list.offer(a, row0 + j, j < nrows && (row_ok == nullptr ||
                                              __ldg(row_ok + row0 + j) != 0));
      }
    }
  }

  // the block's list -> its partial; the last block of the query merges
  merge_warps(list, x_s, x_r, x_n, x_gs, x_gr);
  const size_t part0 = ((size_t)b * gx + bx) * k;
  if (warp == 0) {
    write_list(list, part_s + part0, part_i + part0);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(tickets + b, (unsigned)gx - 1u) == (unsigned)gx - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  if constexpr (kSmall) {
    list.init(k, m_s + warp * 32, m_r + warp * 32);
  } else {
    list.n = list.nb = list.cur = 0;
    list.ts = -INFINITY;
    list.tr = INT_MAX;
  }
  if constexpr (kSmall) {
    // each warp's partials, kBatch of them loaded at once: one round trip
    constexpr int kBatch = 8;
    const float* ps0 = part_s + (size_t)b * gx * k;
    const int* pr0 = part_i + (size_t)b * gx * k;
    for (int g0 = warp; g0 < gx; g0 += kBatch * kWarps) {
      float ps[kBatch];
      int pr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * kWarps;
        const bool in = g < gx && lane < k;
        ps[u] = in ? __ldcg(ps0 + (size_t)g * k + lane) : -INFINITY;
        pr[u] = in ? __ldcg(pr0 + (size_t)g * k + lane) : INT_MAX;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)       // a partial that cannot enter
        if (__any_sync(kFull, better(ps[u], pr[u], list.ts, list.tr)))
          list.merge(ps[u], pr[u]);
    }
  } else {
    for (int g = warp; g < gx; g += kWarps) {
      const size_t p0 = ((size_t)b * gx + g) * k;
      consume(list, part_s + p0, part_i + p0, k);
    }
  }
  merge_warps(list, x_s, x_r, x_n, x_gs, x_gr);
  if (warp == 0) write_list(list, out_s + (size_t)b * k, out_i + (size_t)b * k);
}

template <bool kVec, bool kSmall>
cudaError_t launch_one(const void* cands, int dtype, const void* query,
                       const void* row_ok, int B, int C, int d, int k,
                       Plan pl, size_t shmem, void* part_s, void* part_i,
                       void* list_s, void* list_i, void* tickets,
                       void* out_s, void* out_i, cudaStream_t stream) {
  auto kern = scored_topk_kernel<kVec, kSmall>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(pl.gx, B), kThreads, shmem, stream>>>(
      static_cast<const unsigned char*>(cands), dtype,
      static_cast<const float*>(query), static_cast<const uint8_t*>(row_ok),
      C, d, k, pl, static_cast<float*>(part_s),
      static_cast<int32_t*>(part_i), static_cast<float*>(list_s),
      static_cast<int32_t*>(list_i), static_cast<unsigned*>(tickets),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (one kernel body reads each as
// float32).  vec: rows 16-byte aligned.  row_ok may be null (every row
// eligible).  rs, su, sp, nslice, gx: the plan
// (kernels/topk_score.py:launch_plan); shmem: its shared bytes.
extern "C" int scored_topk(const void* cands, const void* query,
                           const void* row_ok, int B, int C, int d, int dtype,
                           int k, int vec, int rs, int su, int sp, int nslice,
                           int gx, int shmem, void* part_s, void* part_i,
                           void* list_s, void* list_i, void* tickets,
                           void* out_s, void* out_i, void* stream) {
  if (dtype < kF32 || dtype > kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = {rs, su, sp, nslice, gx};
#define SCORED_TOPK_ARGS cands, dtype, query, row_ok, B, C, d, k, pl, shmem, \
    part_s, part_i, list_s, list_i, tickets, out_s, out_i, st
  const bool small = k <= 32;
  cudaError_t e;
  if (vec)
    e = small ? launch_one<true, true>(SCORED_TOPK_ARGS)
              : launch_one<true, false>(SCORED_TOPK_ARGS);
  else
    e = small ? launch_one<false, true>(SCORED_TOPK_ARGS)
              : launch_one<false, false>(SCORED_TOPK_ARGS);
#undef SCORED_TOPK_ARGS
  return static_cast<int>(e);
}

extern "C" const char* scored_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
