// Shared device code of WTBC-DRB's scoring, used by the DRB `and` walk
// (drb_walk.cu) and the DRB bag-of-words query (drb_or.cu).
//
// A document's score is the sum over the query words, left to right from
// +0, of part(tf) * idf, each product rounded and then added; tf-idf's part
// is tf itself, BM25's is tf (k1 + 1) / (tf + k1 norm) with norm = (1 - b)
// + b (doc_len / avg_dl).  Every step is one rounded float32 operation
// (__fdiv_rn, __fmul_rn, __fadd_rn: nvcc would contract a * b + c into an
// FMA otherwise) in core/scoring.py's order, so the kernels' scores equal
// the plain versions' bit for bit.  The constants are the host's float32
// roundings of 1 - b, b, k1 + 1 and k1.
#pragma once

#include <cuda_runtime.h>

namespace drb {

struct Scoring {
  int bm25;
  const float* avg_dl;  // float32 scalar on the card (BM25)
  float one_minus_b, b, k1_plus_1, k1;
};

// BM25's length norm of a document of dl tokens; unused under tf-idf.
__device__ __forceinline__ float doc_norm(const Scoring& sc, float avg_dl,
                                          int dl) {
  const float ratio = __fdiv_rn(__int2float_rn(dl), avg_dl);
  return __fadd_rn(sc.one_minus_b, __fmul_rn(sc.b, ratio));
}

// The per-word factor that multiplies idf (core/scoring.py: part).
__device__ __forceinline__ float word_part(const Scoring& sc, int tf,
                                           float norm) {
  const float x = __int2float_rn(tf);
  return sc.bm25 ? __fdiv_rn(__fmul_rn(x, sc.k1_plus_1),
                             __fadd_rn(x, __fmul_rn(sc.k1, norm)))
                 : x;
}

// One step of the left-to-right sum over the query words.
__device__ __forceinline__ float add_part(float acc, float part, float idf) {
  return __fadd_rn(acc, __fmul_rn(part, idf));
}

}  // namespace drb
