// scored_topk: fused candidate scoring and per-tile top-k.
//
// Replaces the Pallas kernel src/repro/kernels/topk_score.py (_kernel): for
// one query (d,) against C candidate rows (C, d), each tile of T rows is
// scored and reduced to its k best (score, row) pairs; the (n_tiles, k)
// partials are merged outside the kernel, as in the reference.  A batch of
// B independent queries, each with its own (C, d) candidates, runs in one
// launch: the grid's second dimension is the query.
//
// What bounds it on the H100: bytes.  The candidates are read once (C * d *
// element size: 512 MB at C = 10^6, d = 128, float32) and only n_tiles * k
// pairs are written, so no score goes back to device memory.  One thread
// block per (tile, query), 256 threads; each thread scores rows r, r + 256, ... with
// 16-byte loads where rows are 16-byte aligned.  The dot product runs left
// to right over d with __fmul_rn / __fadd_rn (no FMA contraction), the
// port's float contract, so the plain version (an explicit loop over d)
// agrees bitwise.  Scores are staged in shared memory; then k rounds of a
// block-wide max/argmax (warp shuffles, then one warp over the 8 warp
// winners) with ties going to the lower row, the order lax.top_k gives.
// Rows past C (the last tile's padding) are never eligible, so unlike the
// reference's zero-scored padding they cannot take a real row's slot; nor
// are rows whose optional row_ok byte is 0 (a caller's eligibility mask).
// A slot with no eligible row left is (-inf, INT32_MAX).
//
// Layout contract (checked by the Python wrapper): cands contiguous
// (B, C, d) float32 / float16 / bfloat16; query (B, d) float32; row_ok null
// or (B, C) uint8; partial outputs (B, n_tiles, k) float32 / int32, the
// indices row numbers within their query's C rows; (d + T) * 4 + T bytes of
// shared memory; 1 <= k <= T; 1 <= B <= 65535.
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (s, r) precedes (bs, br) in the order (score desc, row asc)
__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

template <typename T, bool kVec>
__device__ __forceinline__ float row_dot(const T* __restrict__ row,
                                         const float* q, int d) {
  float acc = 0.0f;
  if (kVec) {
    constexpr int per = 16 / sizeof(T);
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < d / per; ++c) {
      const uint4 v = __ldg(r4 + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < per; ++j)
        acc = __fadd_rn(acc, __fmul_rn(to_f32(e[j]), q[c * per + j]));
    }
  } else {
    for (int j = 0; j < d; ++j)
      acc = __fadd_rn(acc, __fmul_rn(to_f32(row[j]), q[j]));
  }
  return acc;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
scored_topk_kernel(const T* __restrict__ cands, const float* __restrict__ query,
                   const uint8_t* __restrict__ row_ok, int C, int d, int k,
                   int tile, float* __restrict__ part_s,
                   int32_t* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* q = smem;                                    // (d,)
  float* s = smem + d;                                // (tile,)
  uint8_t* alive = reinterpret_cast<uint8_t*>(s + tile);
  __shared__ float warp_s[kWarps];
  __shared__ int warp_r[kWarps];

  const int t = blockIdx.x;
  const long long row0 = (long long)t * tile;
  // this block's query: its candidates, weights, mask and partial slots
  const long long b = blockIdx.y;
  cands += b * C * d;
  query += b * d;
  if (row_ok != nullptr) row_ok += b * C;
  const size_t out0 = ((size_t)b * gridDim.x + t) * k;
  for (int j = threadIdx.x; j < d; j += kThreads) q[j] = __ldg(query + j);
  __syncthreads();
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const bool real = row0 + r < C;
    s[r] = real ? row_dot<T, kVec>(cands + (row0 + r) * d, q, d) : -INFINITY;
    // padding and masked rows never compete
    alive[r] = real && (row_ok == nullptr || __ldg(row_ok + row0 + r));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int br = INT_MAX;
    for (int r = threadIdx.x; r < tile; r += kThreads)
      if (alive[r] && better(s[r], r, bs, br)) { bs = s[r]; br = r; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int orr = __shfl_xor_sync(0xffffffffu, br, o);
      if (better(os, orr, bs, br)) { bs = os; br = orr; }
    }
    if (lane == 0) { warp_s[warp] = bs; warp_r[warp] = br; }
    __syncthreads();
    if (warp == 0) {
      bs = lane < kWarps ? warp_s[lane] : -INFINITY;
      br = lane < kWarps ? warp_r[lane] : INT_MAX;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, o);
        const int orr = __shfl_xor_sync(0xffffffffu, br, o);
        if (better(os, orr, bs, br)) { bs = os; br = orr; }
      }
      if (lane == 0) {
        part_s[out0 + j] = bs;
        part_i[out0 + j] =
            br == INT_MAX ? INT_MAX : (int32_t)(row0 + br);
        if (br != INT_MAX) alive[br] = 0;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* cands, const void* query, const void* row_ok,
                   int B, int C, int d, int k, int tile, bool vec,
                   void* part_s, void* part_i, cudaStream_t stream) {
  const int n_tiles = (C + tile - 1) / tile;
  const size_t shmem = (size_t)(d + tile) * sizeof(float) + tile;
  auto kern = vec ? scored_topk_kernel<T, true> : scored_topk_kernel<T, false>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_tiles, B), kThreads, shmem, stream>>>(
      static_cast<const T*>(cands), static_cast<const float*>(query),
      static_cast<const uint8_t*>(row_ok), C, d, k, tile,
      static_cast<float*>(part_s), static_cast<int32_t*>(part_i));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  vec: rows are 16-byte aligned
// (d * element size a multiple of 16 and cands 16-byte aligned).  row_ok
// may be null (every row eligible).  B: the number of queries.
extern "C" int scored_topk(const void* cands, const void* query,
                           const void* row_ok, int B, int C, int d, int dtype,
                           int k, int tile, int vec, void* part_s,
                           void* part_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch<float>(cands, query, row_ok, B, C, d, k, tile, vec, part_s,
                        part_i, st);
      break;
    case 1:
      e = launch<__half>(cands, query, row_ok, B, C, d, k, tile, vec, part_s,
                         part_i, st);
      break;
    case 2:
      e = launch<__nv_bfloat16>(cands, query, row_ok, B, C, d, k, tile, vec,
                                part_s, part_i, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* scored_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
