// Placement class of every block of a batch, under a per-row scheme id and ℓ.
//
// Replaces the TPU kernel in src/repro/kernels/classify.py: classify (body
// _make_classify_kernel, which evaluates jax_schemes.elementwise_chain). The
// GC tick calls it on the (V, segment_size) slots of every volume's victim,
// as on the TPU. The port also calls it on each step's user writes, a
// (V, 1) batch with is_gc = 0: a call site the TPU kernel never had (the JAX
// engine classifies user writes with plain jnp). There v = t + 2^30 for a
// fresh LBA, which rounds to float32 on its way to the comparison with ℓ.
//
// The class chain is engine_ops::classify_one (engine_ops.cuh, shared with
// the replay kernel): v and g convert to float32 by round-to-nearest and
// 4ℓ, 16ℓ are exact products, so the classes match the plain PyTorch
// version bit for bit.
//
// What bounds it on this card: memory. Per element it reads 16 bytes and
// writes 4, with a handful of compares: 1.9 MB at (744, 128), about 0.6 us
// at 3.35 TB/s. At that shape the launch itself dominates.
//
// Design: the TPU kernel ran one (8, 128) tile per grid step with the scheme
// id and ℓ as scalar blocks. Here blockIdx.y walks the rows (so each thread
// loads its row's id and ℓ once) and blockIdx.x with the threads covers the
// row with coalesced int32 loads.

#include <cuda_runtime.h>

#include "engine_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
classify_kernel(const int* __restrict__ v, const int* __restrict__ g,
                const int* __restrict__ from_c1, const int* __restrict__ is_gc,
                const float* __restrict__ ell, const int* __restrict__ scheme_ids, int n_rows,
                int row_len, int* __restrict__ out) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= row_len) return;
  for (int row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const long long k = static_cast<long long>(row) * row_len + col;
    const int sid = scheme_ids[row];
    const float e = ell[row];
    out[k] = engine_ops::classify_one(sid, e, v[k], g[k], from_c1[k] != 0, is_gc[k] != 0);
  }
}

}  // namespace

// (V, B) int32 v, g, from_c1, is_gc; (V,) float32 ell; (V,) int32 scheme
// ids -> (V, B) int32 classes. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int classify_launch(const int* v, const int* g, const int* from_c1, const int* is_gc,
                               const float* ell, const int* scheme_ids, int n_rows, int row_len,
                               int* out, void* stream) {
  if (n_rows > 0 && row_len > 0) {
    const dim3 grid((row_len + kThreads - 1) / kThreads,
                    n_rows < kMaxRowBlocks ? n_rows : kMaxRowBlocks);
    classify_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        v, g, from_c1, is_gc, ell, scheme_ids, n_rows, row_len, out);
  }
  return static_cast<int>(cudaGetLastError());
}
