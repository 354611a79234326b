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
// Classes, by the dense scheme id of the row:
//   nosep (0)  0
//   sepgc (1)  is_gc
//   sepbit (2) user: v < ℓ -> 0, else 1; GC: 2 if from class 0,
//              else 3 + [g >= 4ℓ] + [g >= 16ℓ]
//   uw (7)     user: 0/1 as sepbit; GC: 2
//   gw (8)     user: 0; GC: 1 + [g >= 4ℓ] + [g >= 16ℓ]
//   any other  0 (the stateful schemes never consult this kernel)
// v and g convert to float32 by round-to-nearest and 4ℓ, 16ℓ are exact
// products, so the comparisons match the plain PyTorch version bit for bit.
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
    const float vf = __int2float_rn(v[k]);
    const float gf = __int2float_rn(g[k]);
    const bool gc = is_gc[k] != 0;
    const int user_cls = vf < e ? 0 : 1;
    const int older = (gf >= __fmul_rn(4.0f, e) ? 1 : 0) + (gf >= __fmul_rn(16.0f, e) ? 1 : 0);
    int cls = 0;
    switch (sid) {
      case 1:
        cls = gc ? 1 : 0;
        break;
      case 2:
        cls = gc ? (from_c1[k] != 0 ? 2 : 3 + older) : user_cls;
        break;
      case 7:
        cls = gc ? 2 : user_cls;
        break;
      case 8:
        cls = gc ? 1 + older : 0;
        break;
      default:
        cls = 0;
    }
    out[k] = cls;
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
