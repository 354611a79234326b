// GC victim selection: per volume, the argmax of the Greedy or Cost-Benefit
// score over its segments.
//
// Replaces the TPU kernels in src/repro/kernels/segsel.py:
// segment_select_batch (body _segsel_batch_kernel, the fleet GC tick's call)
// and segment_select (body _segsel_kernel, the single-volume call). One
// kernel serves both: the 1-D form is a launch with one volume.
//
// The score of one segment is engine_ops::score_one (engine_ops.cuh, shared
// with the replay kernel): Greedy or Cost-Benefit in the float32 op order of
// _score_tile, -inf for a segment that is not sealed or holds no garbage.
// Ties go to the lowest index; idx is -1 when the best score is -inf.
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

#include "engine_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using engine_ops::beats;
using engine_ops::score_one;

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
