// GC victim selection: per volume, the argmax of the Greedy or Cost-Benefit
// score over its segments.
//
// Replaces the TPU kernels in src/repro/kernels/segsel.py:
// segment_select_batch (body _segsel_batch_kernel, the fleet GC tick's call)
// and segment_select (body _segsel_kernel, the single-volume call). One
// kernel serves both: the 1-D form is a launch with one volume.
//
// Scores, in the float32 op order of _score_tile:
//   greedy        (n - nv) / max(n, 1)
//   cost-benefit  ((1 - u) * age) / (1 + u),  u = nv / max(n, 1),
//                 age = max(t - stime, 0)
// Segments that are not sealed (state != 2) or hold no garbage score -inf.
// Ties go to the lowest index; idx is -1 when the best score is -inf.
// Every op is an explicit round-to-nearest intrinsic and the library is
// built with -fmad=false, so scores are bit-equal to the plain PyTorch
// version.
//
// What bounds it on this card: memory. It reads 16 bytes per segment and
// does about ten float operations on them, far below the card's float32
// rate, so the least time is 16 * V * S bytes over 3.35 TB/s: about 1.3 us
// at the fleet tick's (744, 363). At that shape the launch itself dominates.
//
// Design: one thread block per volume. The TPU kernel walked a volume's
// tiles in grid order and carried its running (max, argmax) in the output
// block between grid steps; blocks on this card run in parallel and share
// nothing, so a strided loop inside the block takes the place of the tile
// axis. Each thread keeps its own (max, lowest index) over a coalesced
// stride, then warp shuffles and one shared-memory round combine them. The
// index is carried as int32 throughout (a float carry would round indices
// above 2^24).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float score_one(int n, int nv, int stime, int state, int t,
                                           int selector) {
  const float nf = __int2float_rn(n);
  const float nvf = __int2float_rn(nv);
  const float garbage = __fsub_rn(nf, nvf);
  const float denom = fmaxf(nf, 1.0f);
  const float greedy = __fdiv_rn(garbage, denom);
  const float u = __fdiv_rn(nvf, denom);
  // int32 subtraction that wraps like the reference's (signed overflow is
  // undefined in C++, so subtract as unsigned)
  int age_i = static_cast<int>(static_cast<unsigned>(t) - static_cast<unsigned>(stime));
  age_i = age_i > 0 ? age_i : 0;
  const float age = __int2float_rn(age_i);
  const float cost_benefit =
      __fdiv_rn(__fmul_rn(__fsub_rn(1.0f, u), age), __fadd_rn(1.0f, u));
  const float score = selector == 0 ? greedy : cost_benefit;
  return (state == 2 && garbage > 0.0f) ? score : -INFINITY;
}

// (s, i) beats (best, best_i): a higher score, or the same score at a lower index
__device__ __forceinline__ bool beats(float s, int i, float best, int best_i) {
  return s > best || (s == best && i < best_i);
}

__global__ void __launch_bounds__(kThreads)
segsel_kernel(const int* __restrict__ seg_n, const int* __restrict__ seg_nvalid,
              const int* __restrict__ seg_stime, const int* __restrict__ seg_state,
              const int* __restrict__ t_in, const int* __restrict__ selector_in,
              int n_segments, int* __restrict__ idx_out, float* __restrict__ score_out) {
  const int v = blockIdx.x;
  const long long base = static_cast<long long>(v) * n_segments;
  const int t = t_in[v];
  const int selector = selector_in[v];

  float best = -INFINITY;
  int best_i = INT_MAX;
  for (int j = threadIdx.x; j < n_segments; j += kThreads) {
    const long long k = base + j;
    const float s = score_one(seg_n[k], seg_nvalid[k], seg_stime[k], seg_state[k], t, selector);
    if (s > best) {  // j rises along the loop, so the first maximum stays
      best = s;
      best_i = j;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (beats(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }

  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_best[warp] = best;
    warp_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kWarps ? warp_best[lane] : -INFINITY;
  best_i = lane < kWarps ? warp_idx[lane] : INT_MAX;
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (beats(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }
  if (lane == 0) {
    score_out[v] = best;
    idx_out[v] = best == -INFINITY ? -1 : best_i;
  }
}

}  // namespace

// (V, S) int32 segment metadata, (V,) int32 clocks and selector ids ->
// (V,) int32 idx, (V,) float32 score. Launches on `stream`; returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int segsel_launch(const int* seg_n, const int* seg_nvalid, const int* seg_stime,
                             const int* seg_state, const int* t, const int* selector_ids,
                             int n_volumes, int n_segments, int* idx_out, float* score_out,
                             void* stream) {
  if (n_volumes > 0) {
    segsel_kernel<<<n_volumes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        seg_n, seg_nvalid, seg_stime, seg_state, t, selector_ids, n_segments, idx_out,
        score_out);
  }
  return static_cast<int>(cudaGetLastError());
}
