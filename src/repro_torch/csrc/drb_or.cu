// drb_or: WTBC-DRB's whole bag-of-words (`or`) query of a (B, Q) batch on
// the card, in three kernels after one memset, with no host sync between
// them.
//
// Redesigns K6 (src/repro/kernels/topk_score.py, _kernel: dot-product
// scoring and a per-tile top-k) for the H100 on the path that spends it:
// the DRB `or` query of core/drb.py gathered every word's documents in
// plain PyTorch (a padded (B, Q, cap + 1) bitmap select, a locate of every
// padded lane with a binary search and a block scan per level, a document
// search, a (B, Q, N + 1) scatter-add, a (B, N, Q) part table) around one
// K3 launch for the base ranks and one K6 launch whose partials two host
// sorts merged, so the card sat idle while K6's own 18 us hardly mattered.
// Here the whole query runs on the card (kernels/drb_or.py: drb_or_ref is
// the plain version, bitwise equal on every result leaf):
//
//   memset  the per-row (N, Q) int32 tf table and the rows' tile counters;
//   prep    (one block, a warp per (row, word)) the word's tables: valid
//           (masked and with a bitmap), df (0 unless valid), the live
//           documents min(df, cap), its bitmap's offset and length, the
//           bitmap rank at its start (warp_rank1) and its idf weight; then
//           an exclusive prefix sum of the live documents over the batch;
//   gather  one warp per live (row, word, j), spread over the whole card
//           by a grid-stride loop over the prefix (a 32-ary search maps a
//           lane to its word): warp_select1 of the j-th and (j+1)-th
//           document start in the word's own bitmap blocks, tf as their gap
//           (or occ - sel for the last), the first occurrence located from
//           the word's leaf level up (warp_locate), the document by a
//           32-ary search of sep_pos, and tf written to its (doc, q) cell.
//           A cell belongs to one lane (a repeated word has its own q
//           column), so no atomics;
//   score   a block per (row, tile of 4,096 documents): each document's
//           parts and score in drb_score.cuh's order, left to right over Q
//           from +0; the documents some valid word occurs in are packed
//           into shared memory as 64-bit keys (score's order bits, then
//           the complement of the document: (score desc, doc asc) is the
//           keys' descending order), sorted by a bitonic sort, and the
//           tile's best min(k, 4096) written out.  The last block of a row
//           to finish (an atomic ticket) merges the row's partials: when
//           their slots fit in shared memory by one more bitonic sort, else
//           by placing each at its rank, counted by binary searches of the
//           other sorted partials.  It writes every leaf of the result.
//
// What bounds it on the H100: latency in the gather, bytes in the score.
// A gather lane is a chain of dependent round trips (two bitmap selects of
// one search round and one 128-byte block each, one byte select per level
// of the locate, three or four rounds of the document search), so many
// lanes have to be in flight: a batch of 8 band-iii rows has tens of
// thousands, run by every SM.  The score pass reads the zeroed table once
// (B * N * Q * 4 bytes) and keeps only the hits in shared memory.
//
// Layout contract (checked by the Python wrapper): levels and word tables
// as for wavelet_count; sep_pos, doc_len (n_docs,) int32; bitmap words
// (n_blocks * 32,) 32-bit patterns, counts (n_blocks + 1,) int32, bit_off
// (V + 1,) int32, has_bm (V,) uint8; df (V,) int32; idf (V,) float32;
// words (B, Q) int32, wmask (B, Q) uint8; outputs top_s (B, k) float32,
// top_d (B, k) int32, n_found, iters, pops (B,) int32, overflowed (B,)
// uint8, certified (B, k) uint8, bound (B,) float32; the scratch of
// scratch_ints() ints.
#include <algorithm>
#include <cstdint>
#include <math_constants.h>

#include "drb_score.cuh"
#include "wtbc_select.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 1024;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kScoreThreads = 512;
constexpr int kTile = 4096;  // documents per score block; keys in shared memory
constexpr int kRowInts = 8;

// One (row, word) entry of the prep kernel's table.
struct WordRow {
  int w, valid, df, live, off, occ, base;
  float idf;
};
static_assert(sizeof(WordRow) == kRowInts * 4, "WordRow is 8 ints");

struct Scratch {
  int32_t* table;     // (B, N, Q) tf, zeroed
  int32_t* tickets;   // (B,) score blocks of the row done, zeroed
  WordRow* rows;      // (B * Q,)
  int32_t* prefix;    // (B * Q + 1,) live documents before each entry
  int32_t* part_len;  // (B, n_tiles) keys in each tile's partial
  unsigned long long* parts;  // (B, n_tiles, m) each tile's best keys
};

__host__ __device__ __forceinline__ int n_tiles_of(int n_docs) {
  return (n_docs + kTile - 1) / kTile;
}

__host__ __device__ __forceinline__ int part_width(int k) {
  return k < kTile ? k : kTile;
}

// Ints of scratch the query needs; the first zeroed() of them are zeroed.
__host__ __forceinline__ long long zeroed_ints(int B, int Q, int n_docs) {
  return (long long)B * n_docs * Q + B;
}

__host__ __forceinline__ long long scratch_ints(int B, int Q, int n_docs,
                                                int k) {
  long long n = zeroed_ints(B, Q, n_docs) + (long long)B * Q * kRowInts +
                (long long)B * Q + 1 + (long long)B * n_tiles_of(n_docs);
  n += n & 1;  // the keys start 8-byte aligned
  return n + 2LL * B * n_tiles_of(n_docs) * part_width(k);
}

__host__ __forceinline__ Scratch carve(int32_t* base, int B, int Q,
                                       int n_docs) {
  Scratch s;
  s.table = base;
  s.tickets = base + (size_t)B * n_docs * Q;
  s.rows = reinterpret_cast<WordRow*>(s.tickets + B);
  s.prefix = reinterpret_cast<int32_t*>(s.rows + (size_t)B * Q);
  s.part_len = s.prefix + (size_t)B * Q + 1;
  long long at = (s.part_len - base) + (long long)B * n_tiles_of(n_docs);
  at += at & 1;
  s.parts = reinterpret_cast<unsigned long long*>(base + at);
  return s;
}

struct Bitmaps {
  const uint32_t* words;
  const int32_t* counts;
  int n_blocks, n_bits;
};

// ---- prep: the words' tables and the prefix of their live documents
__global__ void __launch_bounds__(kPrepThreads)
drb_or_prep_kernel(Bitmaps bv, const int32_t* __restrict__ bit_off,
                   const uint8_t* __restrict__ has_bm,
                   const int32_t* __restrict__ df_g,
                   const float* __restrict__ idf_g,
                   const int32_t* __restrict__ words,
                   const uint8_t* __restrict__ wmask, int bq, int cap,
                   WordRow* rows, int32_t* prefix) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < bq; i += kPrepThreads / 32) {
    const int w = __ldg(words + i);
    const bool valid = __ldg(wmask + i) && __ldg(has_bm + w);
    const int df = valid ? __ldg(df_g + w) : 0;
    const int live = min(df, cap);
    const int off = __ldg(bit_off + w);
    const int occ = __ldg(bit_off + w + 1) - off;
    const int base =  // uniform across the warp
        live > 0 ? wtbc::warp_rank1(bv.words, bv.counts, bv.n_blocks,
                                    bv.n_bits, off)
                 : 0;
    if (lane == 0)
      rows[i] = {w, valid, df, live, off, occ, base,
                 valid ? __ldg(idf_g + w) : 0.f};
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int i0 = 0; i0 < bq; i0 += 32) {
      const int i = i0 + lane;
      const int x = i < bq ? rows[i].live : 0;
      int incl = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (i < bq) prefix[i] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) prefix[bq] = carry;
  }
}

// ---- gather: one warp per live (row, word, j)
__global__ void __launch_bounds__(kGatherThreads)
drb_or_gather_kernel(wtbc::Levels lv, wtbc::WordTables t,
                     const int32_t* __restrict__ sep_pos, int n_docs,
                     Bitmaps bv, const WordRow* __restrict__ rows,
                     const int32_t* __restrict__ prefix, int bq, int Q,
                     int32_t* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const int total = __ldg(prefix + bq);
  const int stride = gridDim.x * kGatherWarps;
  for (int id = blockIdx.x * kGatherWarps + (threadIdx.x >> 5); id < total;
       id += stride) {
    // the entry whose live documents hold this lane: the last one whose
    // prefix is <= id (entries with none share their successor's prefix)
    const int e = wtbc::warp_lower_bound(prefix, 1, bq + 1, id + 1) - 1;
    const WordRow r = rows[e];
    const int j = id - __ldg(prefix + e);
    const wtbc::WordPath path = wtbc::load_path(t, r.w);
    // the word's ones lie in its bitmap's blocks [lo, hi)
    const int blk_lo = r.off / wtbc::kBitsPerBlock;
    const int blk_hi =
        min((r.off + r.occ - 1) / wtbc::kBitsPerBlock + 1, bv.n_blocks);
    const int g = r.base + 1 + j;
    const int sel = wtbc::warp_select1(bv.words, bv.counts, bv.n_blocks,
                                       bv.n_bits, g, blk_lo, blk_hi);
    const int from = min(sel / wtbc::kBitsPerBlock, blk_hi - 1);
    const int next =
        j + 1 < r.df ? wtbc::warp_select1(bv.words, bv.counts, bv.n_blocks,
                                          bv.n_bits, g + 1, from, blk_hi) -
                           r.off
                     : r.occ;
    const int tf = next - (sel - r.off);
    const int pos = wtbc::warp_locate(lv, path, sel - r.off + 1);
    const int d = wtbc::warp_lower_bound(sep_pos, 1, n_docs, pos);
    if (lane == 0 && d < n_docs) {
      const int b = e / Q, q = e - b * Q;
      table[((size_t)b * n_docs + d) * Q + q] = tf;
    }
  }
}

// ---- score, per-tile top-k, and the row's merge by its last block
__device__ __forceinline__ unsigned long long make_key(float s, int d) {
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order of the floats
  return ((unsigned long long)u << 32) | (0xffffffffu - (uint32_t)d);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_doc(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

// Sort keys[0, n) descending, n a power of two (every thread calls it).
__device__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Keys of a descending list greater than `key` (the list written by other
// blocks of this launch: read past L1).
__device__ __forceinline__ int count_greater(const unsigned long long* list,
                                             int n, unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldcg(list + mid) > key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct Out {
  float* top_s;
  int32_t* top_d;
  int32_t *n_found, *iters, *pops;
  uint8_t *overflowed, *certified;
  float* bound;
};

__global__ void __launch_bounds__(kScoreThreads)
drb_or_score_kernel(const int32_t* __restrict__ table,
                    const WordRow* __restrict__ rows,
                    const int32_t* __restrict__ doc_len, int n_docs, int Q,
                    drb::Scoring sc, int k, int cap, int32_t* tickets,
                    int32_t* part_len, unsigned long long* parts, Out out) {
  __shared__ unsigned long long keys[kTile];
  __shared__ int sh_cnt, sh_last, sh_found;
  extern __shared__ float sh_idf[];  // (Q,) idf weights, then (Q,) valid
  int* const sh_valid = reinterpret_cast<int*>(sh_idf + Q);
  const int tid = threadIdx.x;
  const int row = blockIdx.y, tile = blockIdx.x, n_tiles = gridDim.x;
  const int m = part_width(k);
  for (int q = tid; q < Q; q += kScoreThreads) {
    const WordRow& r = rows[(size_t)row * Q + q];
    sh_idf[q] = r.idf;
    sh_valid[q] = r.valid;
  }
  if (tid == 0) sh_cnt = 0;
  __syncthreads();

  // the tile's documents: parts, score, and the hits' keys
  const float avg = sc.bm25 ? *sc.avg_dl : 0.f;
  const int d0 = tile * kTile;
  for (int d = d0 + tid; d < min(d0 + kTile, n_docs); d += kScoreThreads) {
    const int32_t* tf = table + ((size_t)row * n_docs + d) * Q;
    const float norm = sc.bm25 ? drb::doc_norm(sc, avg, __ldg(doc_len + d))
                               : 0.f;
    float acc = 0.f;
    bool hit = false;
    for (int q = 0; q < Q; ++q) {
      const int x = tf[q];
      hit = hit || (x > 0 && sh_valid[q]);
      acc = drb::add_part(acc, drb::word_part(sc, x, norm), sh_idf[q]);
    }
    if (hit) keys[atomicAdd(&sh_cnt, 1)] = make_key(acc, d);
  }
  __syncthreads();
  const int cnt = sh_cnt;
  int n = 1;
  while (n < cnt) n <<= 1;
  for (int i = cnt + tid; i < n; i += kScoreThreads) keys[i] = 0ull;
  __syncthreads();
  bitonic_sort_desc(keys, n);
  const int len = min(cnt, m);
  unsigned long long* mine = parts + ((size_t)row * n_tiles + tile) * m;
  for (int i = tid; i < len; i += kScoreThreads) mine[i] = keys[i];
  if (tid == 0) part_len[(size_t)row * n_tiles + tile] = len;

  // the last block of the row to finish merges the row's partials
  __threadfence();
  __syncthreads();
  if (tid == 0) sh_last = atomicAdd(tickets + row, 1) == n_tiles - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  const unsigned long long* prow = parts + (size_t)row * n_tiles * m;
  const int32_t* lrow = part_len + (size_t)row * n_tiles;
  int e_local = 0;
  for (int t2 = tid; t2 < n_tiles; t2 += kScoreThreads)
    e_local += __ldcg(lrow + t2);
  if (tid == 0) {
    sh_cnt = 0;
    sh_found = 0;
  }
  __syncthreads();
  atomicAdd(&sh_cnt, e_local);
  __syncthreads();
  const int total = sh_cnt;  // the row's kept keys
  const size_t ok = (size_t)row * k;
  for (int i = min(total, k) + tid; i < k; i += kScoreThreads) {
    out.top_s[ok + i] = -CUDART_INF_F;
    out.top_d[ok + i] = -1;
    out.certified[ok + i] = 0;
  }
  int found = 0;
  if ((long long)n_tiles * m <= kTile) {
    // every tile's m slots into shared memory at once (a slot past its
    // tile's keys as 0, below every key), one sort
    const int slots = n_tiles * m;
    n = 1;
    while (n < slots) n <<= 1;
    for (int i = tid; i < n; i += kScoreThreads) {
      const int t2 = i / m;
      keys[i] = i < slots && i - t2 * m < __ldcg(lrow + t2)
                    ? __ldcg(prow + i)
                    : 0ull;
    }
    __syncthreads();
    bitonic_sort_desc(keys, n);
    for (int r = tid; r < min(total, k); r += kScoreThreads) {
      const float s = key_score(keys[r]);
      const bool f = s > -CUDART_INF_F;
      out.top_s[ok + r] = s;
      out.top_d[ok + r] = f ? key_doc(keys[r]) : -1;
      out.certified[ok + r] = f;
      found += f;
    }
  } else {
    // each key at its rank: its index in its own partial plus the keys
    // greater than it in every other partial
    for (size_t s0 = tid; s0 < (size_t)n_tiles * m; s0 += kScoreThreads) {
      const int t2 = (int)(s0 / m), i = (int)(s0 - (size_t)t2 * m);
      if (i >= __ldcg(lrow + t2)) continue;
      const unsigned long long key = __ldcg(prow + s0);
      int r = i;
      for (int t3 = 0; t3 < n_tiles && r < k; ++t3)
        if (t3 != t2)
          r += count_greater(prow + (size_t)t3 * m, __ldcg(lrow + t3), key);
      if (r >= k) continue;
      const float s = key_score(key);
      const bool f = s > -CUDART_INF_F;
      out.top_s[ok + r] = s;
      out.top_d[ok + r] = f ? key_doc(key) : -1;
      out.certified[ok + r] = f;
      found += f;
    }
  }
  atomicAdd(&sh_found, found);
  __syncthreads();
  if (tid == 0) {
    out.n_found[row] = sh_found;
    out.iters[row] = cap;
    out.pops[row] = cap;
    out.overflowed[row] = 0;
    out.bound[row] = -CUDART_INF_F;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace

extern "C" int drb_or(const void* d0, const void* c0, int nb0, int len0,
                      const void* d1, const void* c1, int nb1, int len1,
                      const void* d2, const void* c2, int nb2, int len2,
                      int block, const void* cw, const void* cw_len,
                      const void* node_off, const void* base_rank,
                      const void* sep_pos, const void* doc_len, int n_docs,
                      const void* bv_words, const void* bv_counts,
                      int bv_blocks, int n_bits, const void* bit_off,
                      const void* has_bm, const void* df, const void* idf,
                      const void* words, const void* wmask, int B, int Q,
                      int cap, int bm25, const void* avg_dl,
                      float one_minus_b, float b, float k1_plus_1, float k1,
                      int k, void* top_s, void* top_d, void* n_found,
                      void* iters, void* pops, void* overflowed,
                      void* certified, void* bound, void* scratch,
                      long long scratch_n, void* stream) {
  if (B < 1 || B > 65535 || Q < 1 || n_docs < 1 || cap < 0 || k < 1 ||
      (bm25 && avg_dl == nullptr) || scratch == nullptr ||
      scratch_n != scratch_ints(B, Q, n_docs, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bq = B * Q;
  const Scratch s = carve(static_cast<int32_t*>(scratch), B, Q, n_docs);
  const Bitmaps bv = {static_cast<const uint32_t*>(bv_words),
                      static_cast<const int32_t*>(bv_counts), bv_blocks,
                      n_bits};
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)zeroed_ints(B, Q, n_docs) * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  drb_or_prep_kernel<<<1, kPrepThreads, 0, st>>>(
      bv, static_cast<const int32_t*>(bit_off),
      static_cast<const uint8_t*>(has_bm), static_cast<const int32_t*>(df),
      static_cast<const float*>(idf), static_cast<const int32_t*>(words),
      static_cast<const uint8_t*>(wmask), bq, cap, s.rows, s.prefix);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // every SM busy even when a batch's lanes are few per row; the loop
  // covers the lanes past the grid
  const long long most = (long long)bq * cap;
  const int grid = (int)std::max(
      1LL, std::min((most + kGatherWarps - 1) / kGatherWarps,
                    8LL * sm_count()));
  const wtbc::Levels lv = wtbc::make_levels(d0, c0, nb0, len0, d1, c1, nb1,
                                            len1, d2, c2, nb2, len2, block);
  const wtbc::WordTables t = wtbc::make_tables(cw, cw_len, node_off, base_rank);
  drb_or_gather_kernel<<<grid, kGatherThreads, 0, st>>>(
      lv, t, static_cast<const int32_t*>(sep_pos), n_docs, bv, s.rows,
      s.prefix, bq, Q, s.table);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const drb::Scoring sc = {bm25, static_cast<const float*>(avg_dl),
                           one_minus_b, b, k1_plus_1, k1};
  const Out out = {static_cast<float*>(top_s), static_cast<int32_t*>(top_d),
                   static_cast<int32_t*>(n_found), static_cast<int32_t*>(iters),
                   static_cast<int32_t*>(pops),
                   static_cast<uint8_t*>(overflowed),
                   static_cast<uint8_t*>(certified), static_cast<float*>(bound)};
  drb_or_score_kernel<<<dim3(n_tiles_of(n_docs), B), kScoreThreads,
                        (size_t)Q * 8, st>>>(
      s.table, s.rows, static_cast<const int32_t*>(doc_len), n_docs, Q, sc, k,
      cap, s.tickets, s.part_len, s.parts, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* drb_or_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
