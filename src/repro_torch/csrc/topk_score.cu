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
// element size: 512 MB at C = 10^6, d = 128; 200 MB at SASRec's d = 50,
// float32) and only (B, k) pairs are written.  The design:
//
// * Staging, aligned or not.  A persistent grid (gx blocks per query, one
//   block of 8 warps per SM) walks the query's rows in row blocks of rs
//   rows; each warp takes every (gx * 8)-th row block and copies it into
//   its own ring of ns stages in shared memory with cp.async, ns - 1 stages
//   ahead of the one it scores, so the loads overlap the scoring.  A row is
//   u units of g bytes, g the largest of 16, 8, 4, 2 that divides the row's
//   bytes and the candidates' address (200-byte rows: g = 8, u = 25), and
//   is stored at a stride of sp units, sp odd, so the lanes reading rows
//   j, j + 1, ... at one unit hit different banks: no bank conflict (the
//   padded-stride choice; no TMA swizzle).  When u is odd (sp = u) the row
//   block is one contiguous span of rs * u * g bytes and is copied as it
//   lies, in 16-byte pieces where the span's start and length allow it
//   (32 rows of 200 bytes: 6,400 bytes), else in g-byte pieces; a padded
//   stride copies unit by unit (g = 2, which cp.async cannot move, by plain
//   loads).  Rows wider than a stage are staged in slices of su units, the
//   running sum kept in a register between slices.  The row_ok mask bytes
//   of a stage's rows ride in the same cp.async group.
// * Float contract.  Lane j scores row j of the stage, left to right over d
//   with __fmul_rn / __fadd_rn (no FMA contraction), so the plain version (a
//   loop over d, each product rounded and then added) agrees bitwise.
// * k <= 32: each warp keeps its k best as it goes, a sorted list in
//   registers (lane i the i-th best); a row that is not better than the
//   warp's k-th (score desc, row asc) is dropped at once; up to two rows of
//   a round that pass are inserted one by one (ballot and shuffle), more
//   are sorted by a bitonic network over the lanes and merged by rank.  A
//   block merges its warps' lists into warp 0's (a tree of pairwise rank
//   merges); the last block of a query merges the gx partials.
// * k > 32: a threshold and a block-wide selection.  The block keeps one
//   candidate buffer (nc entries: in shared memory, or in a global scratch
//   for a k too large for it) and a threshold t, the k-th best score the
//   buffer has held, raised only upward.  A row scoring below t never
//   enters (one equal to t still competes: ties go to the lower row); rows
//   that pass are appended by a warp-aggregated atomic.  The warps of a
//   block walk their row blocks in step, with a barrier every `every` row
//   blocks (the buffer keeps room for that many); when the buffer could
//   overflow, the whole block keeps its k best: a radix select of the k-th
//   greatest 64-bit key (the score's order bits, then the row's
//   complement) over 8-bit digits (a 256-bin shared histogram, one atomic
//   per distinct digit of a warp, stopping at the first digit whose bucket
//   is taken whole), then a block scan compacts the k kept entries in
//   place and t becomes their least score.  A block's partial is its k (or fewer) entries, unsorted, and
//   its t.  The last block of a query raises t to the largest partial
//   threshold, streams the partials through its buffer (its stage memory
//   then serves as one large buffer) with the same filter and selection,
//   and sorts the k it keeps with a bitonic network over the block.  The
//   merge has two levels: the last block of each group of about sqrt(gx)
//   blocks merges its group's partials into one, then the last of those
//   merges the groups' (a few thousand entries each, not gx * k).
// * Merge in the launch.  The last block of a query (or of a group) is
//   found by a ticket (atomicInc, which wraps the counter back to 0 for
//   the next launch) and writes (k,) scores and rows.  No further launch and no host
//   merge.
//
// Semantics: ties go to the lower row; rows past C never compete, nor rows
// whose optional row_ok byte is 0; a slot no eligible row fills is (-inf,
// INT32_MAX); a NaN score never competes.
//
// Layout contract (checked by the Python wrapper, which plans the unit g,
// rs, su, sp, nslice, ns, gx, nc, every and grp:
// kernels/topk_score.py:launch_plan):
// cands contiguous (B, C, d) float32 / float16 / bfloat16, g dividing the
// row's bytes and the address; query (B, d) float32; row_ok null or (B, C)
// uint8; scratch part (B, gx, k), thresholds (B, gx) (k > 32), the global
// buffer (B, gx, nc) when nc entries do not fit shared memory; tickets (B,)
// and the groups' (B * groups) uint32, zero before the first launch; out
// (B, k).
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

// The shared-memory load of one g-byte unit.
template <int kG> struct UnitT;
template <> struct UnitT<16> { using T = uint4; };
template <> struct UnitT<8> { using T = uint2; };
template <> struct UnitT<4> { using T = unsigned; };
template <> struct UnitT<2> { using T = unsigned short; };

// a + the products of uw units of kG bytes of dtype kD with q, left to
// right, each rounded and then added (no FMA contraction)
template <int kG, int kD>
__device__ __forceinline__ float dot_units(float a, const unsigned char* row,
                                           int uw, const float* q) {
  constexpr int per = kG / (kD == kF32 ? 4 : 2);
  if constexpr (per > 0) {
    for (int u = 0; u < uw; ++u) {
      const typename UnitT<kG>::T v =
          reinterpret_cast<const typename UnitT<kG>::T*>(row)[u];
      const unsigned char* e = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
      for (int i = 0; i < per; ++i)
        a = __fadd_rn(a, __fmul_rn(elem(e, i, kD), __ldg(q + u * per + i)));
    }
  }
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
// one kG-byte piece: cp.async for 4, 8 and 16 bytes, a plain copy for 2
template <int kG>
__device__ __forceinline__ void copy_piece(void* dst, const void* src) {
  if constexpr (kG == 16) {
    cp_async16(dst, src);
  } else if constexpr (kG >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(kG));
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// every group but the newest ns - 2 complete (ns stages in the ring)
__device__ __forceinline__ void cp_async_wait_ring(int ns) {
  if (ns >= 4) cp_async_wait<3>();
  else if (ns == 3) cp_async_wait<2>();
  else cp_async_wait<1>();
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
};

// Merge the block's register lists into warp 0's: a tree of pairwise
// merges through the shared exchange xs / xr (kWarps * 32 entries).  Every
// thread calls it.
__device__ void merge_warps(RegList& list, float* xs, int* xr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
}

// ---- k > 32: the block's candidate buffer and its selection

// The 64-bit sort key of (score desc, row asc): the score's order bits (-0
// as +0), then the row's complement; greater is better.
__device__ __forceinline__ unsigned ord_bits(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ unsigned long long skey(float s, int r) {
  return (static_cast<unsigned long long>(ord_bits(s)) << 32) |
         (0xffffffffu - static_cast<unsigned>(r));
}

struct Buf {
  float* s;      // nc scores, then nc rows (shared or global memory)
  int* r;
  int cap;
};

// The block's shared state of a k > 32 selection.
struct SelState {
  unsigned hist[256];
  int sc[12];
  int cnt;              // entries in the buffer
  float thr;            // no row scoring below it can enter the k best
  unsigned thr_ord;     // the kept entries' least score (order bits)
};

// Append (s, r) of the lanes with `pass` to the buffer (every lane of the
// warp calls it).
__device__ __forceinline__ void append(const Buf& bf, SelState& st, bool pass,
                                       float s, int r) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(kFull, pass);
  if (!m) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&st.cnt, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (pass) {
    const int i = base + __popc(m & ((1u << lane) - 1u));
    bf.s[i] = s;
    bf.r[i] = r;
  }
}

// Block-wide exclusive scan of v; *total gets the sum.  Every thread calls
// it; sc holds kWarps ints.
__device__ __forceinline__ int block_scan(int v, int* sc, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sc[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) off += sc[w];
    tot += sc[w];
  }
  *total = tot;
  __syncthreads();
  return off + incl - v;
}

// hist[digit] += 1 from every lane with digit < 256, one shared atomic per
// distinct digit of the warp (the keys of a buffer mostly share their top
// digits: per-lane atomics on one bin would serialize).  Every lane of the
// warp calls it.
__device__ __forceinline__ void hist_add(unsigned* hist, int digit) {
  const unsigned peers = __match_any_sync(kFull, digit);
  if (digit < 256 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
}

// Keep the k best of the buffer's cnt > k entries, in place and unordered;
// st.thr becomes their least score.  Every thread calls it; it ends with a
// barrier.
__device__ void keep_k(const Buf& bf, SelState& st, int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = st.cnt;
  // radix select of the k-th greatest key: 8-bit digits, greatest first
  unsigned long long pre = 0ull;
  int want = k;
  for (int sh = 56; sh >= 0; sh -= 8) {
    const unsigned long long hm = sh == 56 ? 0ull : ~0ull << (sh + 8);
    st.hist[tid] = 0u;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kThreads) {   // uniform trip count
      const int i = i0 + tid;
      int digit = 256;                            // 256: not counted
      if (i < n) {
        const unsigned long long key = skey(bf.s[i], bf.r[i]);
        if ((key & hm) == (pre & hm)) digit = (int)((key >> sh) & 255u);
      }
      hist_add(st.hist, digit);
    }
    __syncthreads();
    const int h = static_cast<int>(st.hist[tid]);   // suffix sums S(b)
    int s = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_down_sync(kFull, s, o);
      if (lane + o < 32) s += v;
    }
    if (lane == 0) st.sc[warp] = s;
    __syncthreads();
    for (int w = warp + 1; w < kWarps; ++w) s += st.sc[w];
    if (s >= want && s - h < want) {  // the bucket crossing want
      st.sc[8] = tid;
      st.sc[9] = s - h;
      st.sc[10] = h;
    }
    __syncthreads();
    pre |= static_cast<unsigned long long>(st.sc[8]) << sh;
    want -= st.sc[9];
    const bool whole = st.sc[10] == want;
    __syncthreads();           // st.sc is read before the next pass writes
    if (whole) break;
  }
  // compact the kept entries (key >= pre) to the front, in rounds of
  // kThreads * kE: a round's entries are read before any is written
  constexpr int kE = 8;
  if (tid == 0) st.thr_ord = 0xffffffffu;
  int out = 0;
  unsigned lo = 0xffffffffu;
  for (int base = 0; base < n; base += kThreads * kE) {
    float vs[kE];
    int vr[kE];
    unsigned keep = 0u;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = base + tid * kE + e;
      vs[e] = 0.0f;
      vr[e] = 0;
      if (i < n) {
        vs[e] = bf.s[i];
        vr[e] = bf.r[i];
        if (skey(vs[e], vr[e]) >= pre) {
          keep |= 1u << e;
          lo = min(lo, ord_bits(vs[e]));
        }
      }
    }
    int total;
    const int off = out + block_scan(__popc(keep), st.sc, &total);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (keep & (1u << e)) {
        const int i = off + __popc(keep & ((1u << e) - 1u));
        bf.s[i] = vs[e];
        bf.r[i] = vr[e];
      }
    out += total;
    __syncthreads();
  }
  atomicMin(&st.thr_ord, lo);
  __syncthreads();
  if (tid == 0) {
    st.cnt = out;                                   // == k
    st.thr = fmaxf(st.thr, from_ord(st.thr_ord));
  }
  __syncthreads();
}

// Sort the buffer's first n entries best first (a bitonic network over the
// block, padded to a power of two with (-inf, INT_MAX)); the buffer holds
// at least that power of two.
__device__ void sort_buf(const Buf& bf, int n) {
  int P = 2;
  while (P < n) P <<= 1;
  for (int i = n + threadIdx.x; i < P; i += kThreads) {
    bf.s[i] = -INFINITY;
    bf.r[i] = INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += kThreads) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool first_best = (i & size) == 0;
        const float a = bf.s[i], b = bf.s[j];
        const int ra = bf.r[i], rb = bf.r[j];
        if (first_best ? better(b, rb, a, ra) : better(a, ra, b, rb)) {
          bf.s[i] = b; bf.r[i] = rb; bf.s[j] = a; bf.r[j] = ra;
        }
      }
      __syncthreads();
    }
  }
}

// A block's (or a group's) partial: the buffer's n <= k entries, then
// (-inf, INT_MAX), and its threshold (-inf below k entries).
__device__ void write_part(const Buf& bf, const SelState& st, int k,
                           float* ps, int32_t* pr, float* pt, size_t slot) {
  const int n = st.cnt;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    ps[slot * k + i] = i < n ? bf.s[i] : -INFINITY;
    pr[slot * k + i] = i < n ? bf.r[i] : INT_MAX;
  }
  if (threadIdx.x == 0) pt[slot] = n >= k ? st.thr : -INFINITY;
}

// Every thread: true in the last of n blocks to take the ticket (atomicInc
// wraps the counter back to 0 for the next launch); the block's writes are
// fenced before, the others' seen after.
__device__ bool take_ticket(unsigned* counter, int n, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicInc(counter, (unsigned)n - 1u) == (unsigned)n - 1u;
  __syncthreads();
  const bool last = *s_last;
  if (last) __threadfence();
  return last;
}

// Stream `count` partials of k entries (slots first, first + stride, ...)
// through the buffer behind the largest of their thresholds, keeping the k
// best; st.cnt <= k entries remain.  Every thread calls it.
__device__ void merge_parts(const Buf& bf, SelState& st, const float* ps,
                            const int32_t* pr, const float* pt, size_t first,
                            int count, int stride, int k) {
  if (threadIdx.x == 0) {
    st.cnt = 0;
    st.thr_ord = 0u;
  }
  __syncthreads();
  unsigned t = 0u;
  for (int c = threadIdx.x; c < count; c += kThreads)
    t = max(t, ord_bits(__ldcg(pt + first + (size_t)c * stride)));
  atomicMax(&st.thr_ord, t);
  __syncthreads();
  if (threadIdx.x == 0) st.thr = from_ord(st.thr_ord);
  __syncthreads();
  const int total = count * k, room = bf.cap - k;
  for (int e0 = 0; e0 < total; e0 += room) {
    if (st.cnt > k) keep_k(bf, st, k);        // uniform: read after a barrier
    const int e1 = min(total, e0 + room);
    for (int j0 = e0; j0 < e1; j0 += kThreads) {
      const int e = j0 + threadIdx.x;
      float s = -INFINITY;
      int r = INT_MAX;
      if (e < e1) {
        const int c = e / k;
        const size_t at = (first + (size_t)c * stride) * k + (e - c * k);
        s = __ldcg(ps + at);
        r = __ldcg(pr + at);
      }
      append(bf, st, e < e1 && r != INT_MAX && s >= st.thr, s, r);
    }
    __syncthreads();
  }
  if (st.cnt > k) keep_k(bf, st, k);
}

struct Plan {
  int rs, su, sp, nslice, gx, ns, nc, every, grp;
};

template <int kG, bool kSmall>
__global__ void __launch_bounds__(kThreads)
scored_topk_kernel(const unsigned char* __restrict__ cands, int dtype,
                   const float* __restrict__ query,
                   const uint8_t* __restrict__ row_ok, int C, int d, int k,
                   Plan pl, int buf_in_smem, float* __restrict__ part_s,
                   int32_t* __restrict__ part_i, float* __restrict__ part_t,
                   float* __restrict__ gbuf_s, int32_t* __restrict__ gbuf_i,
                   unsigned* tickets, unsigned* gtickets,
                   float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float x_s[kWarps * 32], m_s[kWarps * 32];
  __shared__ int x_r[kWarps * 32], m_r[kWarps * 32];
  __shared__ SelState sel;
  __shared__ bool s_last;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, b = blockIdx.y, gx = pl.gx;
  const int es = dtype == kF32 ? 4 : 2;        // bytes per element
  cands += (size_t)b * C * d * es;
  query += (size_t)b * d;
  if (row_ok != nullptr) row_ok += (size_t)b * C;

  // this warp's shared memory: ns stages and their mask windows; the k > 32
  // buffer after every warp's
  const int upr = d * es / kG;                 // units per row
  const int stage_bytes = pl.rs * pl.sp * kG;
  const int mask_bytes = row_ok != nullptr ? (pl.rs + 31) & ~15 : 0;
  const int warp_bytes = pl.ns * (stage_bytes + mask_bytes);
  unsigned char* mine = smem + (size_t)warp * warp_bytes;
  unsigned char* masks = mine + pl.ns * stage_bytes;
  const size_t ring_bytes = (size_t)kWarps * warp_bytes;

  RegList list;
  Buf bf;
  if constexpr (kSmall) {
    list.init(k, m_s + warp * 32, m_r + warp * 32);
  } else {
    const size_t slot = (size_t)b * gx + bx;
    if (buf_in_smem) {
      bf.s = reinterpret_cast<float*>(smem + ring_bytes);
      bf.r = reinterpret_cast<int*>(bf.s + pl.nc);
    } else {
      bf.s = gbuf_s + slot * pl.nc;
      bf.r = gbuf_i + slot * pl.nc;
    }
    bf.cap = pl.nc;
    if (threadIdx.x == 0) {
      sel.cnt = 0;
      sel.thr = -INFINITY;
    }
    __syncthreads();
  }

  const int n_rb = (C + pl.rs - 1) / pl.rs;
  const int wid = bx * kWarps + warp, wstep = gx * kWarps;
  // row blocks of this warp; k > 32: every warp of the grid walks the same
  // count (in step with its block), idle past the rows
  const int n_it = kSmall ? (wid < n_rb ? (n_rb - 1 - wid) / wstep + 1 : 0)
                          : (n_rb + wstep - 1) / wstep;
  const int n_st = n_it * pl.nslice;

  auto stage_in = [&](int st) {
    const int rb = wid + (st / pl.nslice) * wstep, sl = st % pl.nslice;
    if (rb >= n_rb) return;
    const int row0 = rb * pl.rs, nrows = min(pl.rs, C - row0);
    const int u0 = sl * pl.su, uw = min(pl.su, upr - u0);
    unsigned char* slot = mine + (st % pl.ns) * stage_bytes;
    const unsigned char* src = cands + ((size_t)row0 * upr + u0) * kG;
    if (pl.sp == upr) {
      // the row block is one contiguous span: copied as it lies
      const int bytes = nrows * upr * kG;
      if (kG < 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
          (bytes & 15) == 0) {
        for (int p = lane; p < bytes / 16; p += 32)
          cp_async16(slot + 16 * p, src + 16 * p);
      } else {
        for (int p = lane; p < bytes / kG; p += 32)
          copy_piece<kG>(slot + kG * p, src + kG * p);
      }
    } else {
      const int pieces = nrows * uw;
      const int dq = 32 / uw, dr = 32 % uw;
      int row = lane / uw, unit = lane % uw;
      for (int p = lane; p < pieces; p += 32) {
        copy_piece<kG>(slot + ((size_t)row * pl.sp + unit) * kG,
                       src + ((size_t)row * upr + unit) * kG);
        unit += dr;
        row += dq;
        if (unit >= uw) { unit -= uw; ++row; }
      }
    }
    if (mask_bytes && sl == pl.nslice - 1) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(row_ok + row0);
      const uintptr_t a0 = a & ~uintptr_t(15);
      const int units = (int)((a + nrows - a0 + 15) >> 4);
      unsigned char* ms = masks + (st % pl.ns) * mask_bytes;
      for (int u = lane; u < units; u += 32)
        cp_async16(ms + 16 * u, reinterpret_cast<const void*>(a0 + 16 * u));
    }
  };

  float acc = 0.0f;
  auto score = [&](int st) {
    const int rb = wid + (st / pl.nslice) * wstep, sl = st % pl.nslice;
    if (rb >= n_rb) return;                     // uniform over the warp
    const int row0 = rb * pl.rs, nrows = min(pl.rs, C - row0);
    const int u0 = sl * pl.su, uw = min(pl.su, upr - u0);
    const unsigned char* slot = mine + (st % pl.ns) * stage_bytes;
    const unsigned char* ms = masks + (st % pl.ns) * mask_bytes +
        (reinterpret_cast<uintptr_t>(row_ok + row0) & 15);
    const float* q = query + u0 * (kG / es);
    for (int j0 = 0; j0 < nrows; j0 += 32) {     // uniform
      const int j = j0 + lane;
      float a = sl == 0 ? 0.0f : acc;
      if (j < nrows) {
        const unsigned char* rowp = slot + (size_t)j * pl.sp * kG;
        if (dtype == kF32) a = dot_units<kG, kF32>(a, rowp, uw, q);
        else if (dtype == kF16) a = dot_units<kG, kF16>(a, rowp, uw, q);
        else a = dot_units<kG, kBF16>(a, rowp, uw, q);
      }
      acc = a;
      if (sl == pl.nslice - 1) {
        const bool ok = j < nrows && (row_ok == nullptr || ms[j] != 0);
        if constexpr (kSmall) list.offer(a, row0 + j, ok);
        else append(bf, sel, ok && a >= sel.thr, a, row0 + j);
      }
    }
  };

  for (int p = 0; p < pl.ns - 1; ++p) {
    if (p < n_st) stage_in(p);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    if (st + pl.ns - 1 < n_st) stage_in(st + pl.ns - 1);
    cp_async_commit();
    cp_async_wait_ring(pl.ns);
    __syncwarp();
    score(st);
    __syncwarp();                        // before the slot is refilled
    if constexpr (!kSmall) {
      const int it = st / pl.nslice;     // uniform: every warp walks n_it
      if (st % pl.nslice == pl.nslice - 1 && it % pl.every == pl.every - 1) {
        __syncthreads();                 // the block's row blocks appended
        if (sel.cnt > bf.cap - pl.every * kWarps * pl.rs) keep_k(bf, sel, k);
      }
    }
  }
  cp_async_wait<0>();

  // the block's partial; the last block of the query merges (k > 32: the
  // last block of each group of pl.grp merges the group's partials, then
  // the last of those merges the groups')
  if constexpr (kSmall) {
    const size_t part0 = ((size_t)b * gx + bx) * k;
    merge_warps(list, x_s, x_r);
    if (warp == 0 && lane < k) {         // entries past the real ones are
      part_s[part0 + lane] = list.s;     // (-inf, INT_MAX)
      part_i[part0 + lane] = list.r;
    }
    if (!take_ticket(tickets + b, gx, &s_last)) return;
    list.init(k, m_s + warp * 32, m_r + warp * 32);
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
    merge_warps(list, x_s, x_r);
    if (warp == 0 && lane < k) {
      out_s[(size_t)b * k + lane] = list.s;
      out_i[(size_t)b * k + lane] = list.r;
    }
  } else {
    __syncthreads();
    if (sel.cnt > k) keep_k(bf, sel, k);
    const size_t q0 = (size_t)b * gx;          // the query's first slot
    write_part(bf, sel, k, part_s, part_i, part_t, q0 + bx);
    const int grp = pl.grp, ng = (gx + grp - 1) / grp, g = bx / grp;
    if (!take_ticket(gtickets + (size_t)b * ng + g, min(grp, gx - g * grp),
                     &s_last))
      return;
    // the stage memory (and the buffer after it) as one large buffer
    const size_t dyn = ring_bytes + (buf_in_smem ? (size_t)pl.nc * 8 : 0);
    if (dyn / 8 >= (size_t)pl.nc) {
      bf.cap = static_cast<int>(dyn / 8);
      bf.s = reinterpret_cast<float*>(smem);
      bf.r = reinterpret_cast<int*>(bf.s + bf.cap);
    }
    merge_parts(bf, sel, part_s, part_i, part_t, q0 + g * grp,
                min(grp, gx - g * grp), 1, k);
    if (ng > 1) {                    // the group's k best in its first slot
      write_part(bf, sel, k, part_s, part_i, part_t, q0 + g * grp);
      if (!take_ticket(tickets + b, ng, &s_last)) return;
      merge_parts(bf, sel, part_s, part_i, part_t, q0, ng, grp, k);
    }
    const int n = sel.cnt;
    sort_buf(bf, n);
    for (int i = threadIdx.x; i < k; i += kThreads) {
      out_s[(size_t)b * k + i] = i < n ? bf.s[i] : -INFINITY;
      out_i[(size_t)b * k + i] = i < n ? bf.r[i] : INT_MAX;
    }
  }
}

template <int kG, bool kSmall>
cudaError_t launch_one(const void* cands, int dtype, const void* query,
                       const void* row_ok, int B, int C, int d, int k,
                       Plan pl, int buf_in_smem, size_t shmem, void* part_s,
                       void* part_i, void* part_t, void* gbuf_s,
                       void* gbuf_i, void* tickets, void* gtickets,
                       void* out_s, void* out_i, cudaStream_t stream) {
  auto kern = scored_topk_kernel<kG, kSmall>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(pl.gx, B), kThreads, shmem, stream>>>(
      static_cast<const unsigned char*>(cands), dtype,
      static_cast<const float*>(query), static_cast<const uint8_t*>(row_ok),
      C, d, k, pl, buf_in_smem, static_cast<float*>(part_s),
      static_cast<int32_t*>(part_i), static_cast<float*>(part_t),
      static_cast<float*>(gbuf_s), static_cast<int32_t*>(gbuf_i),
      static_cast<unsigned*>(tickets), static_cast<unsigned*>(gtickets),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return cudaGetLastError();
}

template <bool kSmall>
cudaError_t launch_unit(int unit, const void* cands, int dtype,
                        const void* query, const void* row_ok, int B, int C,
                        int d, int k, Plan pl, int buf_in_smem, size_t shmem,
                        void* part_s, void* part_i, void* part_t,
                        void* gbuf_s, void* gbuf_i, void* tickets,
                        void* gtickets, void* out_s, void* out_i,
                        cudaStream_t st) {
#define SCORED_TOPK_ARGS cands, dtype, query, row_ok, B, C, d, k, pl, \
    buf_in_smem, shmem, part_s, part_i, part_t, gbuf_s, gbuf_i, tickets, \
    gtickets, out_s, out_i, st
  switch (unit) {
    case 16: return launch_one<16, kSmall>(SCORED_TOPK_ARGS);
    case 8: return launch_one<8, kSmall>(SCORED_TOPK_ARGS);
    case 4: return launch_one<4, kSmall>(SCORED_TOPK_ARGS);
    case 2: return launch_one<2, kSmall>(SCORED_TOPK_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SCORED_TOPK_ARGS
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (one kernel body reads each as
// float32).  unit: the staging unit g in bytes (16, 8, 4 or 2).  row_ok may
// be null (every row eligible).  rs, su, sp, nslice, ns, gx, nc, every,
// grp, buf_in_smem: the plan (kernels/topk_score.py:launch_plan); shmem:
// its dynamic shared bytes.  tickets (B,) and gtickets (B * groups) zero.
extern "C" int scored_topk(const void* cands, const void* query,
                           const void* row_ok, int B, int C, int d, int dtype,
                           int k, int unit, int rs, int su, int sp,
                           int nslice, int ns, int gx, int nc, int every,
                           int grp, int buf_in_smem, int shmem, void* part_s,
                           void* part_i, void* part_t, void* gbuf_s,
                           void* gbuf_i, void* tickets, void* gtickets,
                           void* out_s, void* out_i, void* stream) {
  if (dtype < kF32 || dtype > kBF16 || ns < 2 || ns > 4 || every < 1 ||
      grp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = {rs, su, sp, nslice, gx, ns, nc, every, grp};
  const cudaError_t e =
      k <= 32 ? launch_unit<true>(unit, cands, dtype, query, row_ok, B, C, d,
                                  k, pl, buf_in_smem, (size_t)shmem, part_s,
                                  part_i, part_t, gbuf_s, gbuf_i, tickets,
                                  gtickets, out_s, out_i, st)
              : launch_unit<false>(unit, cands, dtype, query, row_ok, B, C,
                                   d, k, pl, buf_in_smem, (size_t)shmem,
                                   part_s, part_i, part_t, gbuf_s, gbuf_i,
                                   tickets, gtickets, out_s, out_i, st);
  return static_cast<int>(e);
}

extern "C" const char* scored_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
