// The replay engine's per-element arithmetic, shared by the victim-selection
// kernel (segsel.cu), the classify kernel (classify.cu) and the per-volume
// replay kernel (replay.cu), so that it exists once.
//
// Every float op is an explicit round-to-nearest intrinsic and the kernels
// are built with -fmad=false, so the results are bit-equal to the plain
// PyTorch versions in kernels/ref.py.

#pragma once

#include <cmath>

namespace engine_ops {

// Victim score of one segment, in the float32 op order of the JAX package's
// _score_tile:
//   greedy        (n - nv) / max(n, 1)
//   cost-benefit  ((1 - u) * age) / (1 + u),  u = nv / max(n, 1),
//                 age = max(t - stime, 0)
// A segment that is not sealed (state != 2) or holds no garbage scores -inf.
// `eligible` and the two scores are score_one's parts, for a scan that
// scores only eligible rows under one selector.
__device__ __forceinline__ bool eligible(int n, int nv, int state) {
  return state == 2 && __fsub_rn(__int2float_rn(n), __int2float_rn(nv)) > 0.0f;
}

__device__ __forceinline__ float greedy_score(int n, int nv) {
  const float nf = __int2float_rn(n);
  return __fdiv_rn(__fsub_rn(nf, __int2float_rn(nv)), fmaxf(nf, 1.0f));
}

__device__ __forceinline__ float cost_benefit_score(int n, int nv, int stime, int t) {
  const float u = __fdiv_rn(__int2float_rn(nv), fmaxf(__int2float_rn(n), 1.0f));
  // int32 subtraction that wraps like the reference's (signed overflow is
  // undefined in C++, so subtract as unsigned)
  int age_i = static_cast<int>(static_cast<unsigned>(t) - static_cast<unsigned>(stime));
  age_i = age_i > 0 ? age_i : 0;
  const float age = __int2float_rn(age_i);
  return __fdiv_rn(__fmul_rn(__fsub_rn(1.0f, u), age), __fadd_rn(1.0f, u));
}

__device__ __forceinline__ float score_one(int n, int nv, int stime, int state, int t,
                                           int selector) {
  const float score = selector == 0 ? greedy_score(n, nv) : cost_benefit_score(n, nv, stime, t);
  return eligible(n, nv, state) ? score : -INFINITY;
}

// (s, i) beats (best, best_i): a higher score, or the same score at a lower index
__device__ __forceinline__ bool beats(float s, int i, float best, int best_i) {
  return s > best || (s == best && i < best_i);
}

// Placement class of one block under the dense scheme id `sid` and ℓ `e`
// (the elementwise chain of the JAX package's jax_schemes):
//   nosep (0)  0
//   sepgc (1)  is_gc
//   sepbit (2) user: v < ℓ -> 0, else 1; GC: 2 if from class 0,
//              else 3 + [g >= 4ℓ] + [g >= 16ℓ]
//   uw (7)     user: 0/1 as sepbit; GC: 2
//   gw (8)     user: 0; GC: 1 + [g >= 4ℓ] + [g >= 16ℓ]
//   any other  0 (the stateful schemes never consult it)
// v and g convert to float32 by round-to-nearest; 4ℓ and 16ℓ are exact.
__device__ __forceinline__ int classify_one(int sid, float e, int v, int g, bool from_c1,
                                            bool gc) {
  const float vf = __int2float_rn(v);
  const float gf = __int2float_rn(g);
  const int user_cls = vf < e ? 0 : 1;
  const int older = (gf >= __fmul_rn(4.0f, e) ? 1 : 0) + (gf >= __fmul_rn(16.0f, e) ? 1 : 0);
  switch (sid) {
    case 1:
      return gc ? 1 : 0;
    case 2:
      return gc ? (from_c1 ? 2 : 3 + older) : user_cls;
    case 7:
      return gc ? 2 : user_cls;
    case 8:
      return gc ? 1 + older : 0;
    default:
      return 0;
  }
}

}  // namespace engine_ops
