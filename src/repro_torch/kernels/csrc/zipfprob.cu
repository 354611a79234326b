// The four Zipf probability sums behind the paper's Figs 8 and 10.
//
// Replaces the TPU kernel in src/repro/kernels/zipfprob.py: zipf_bit_sums
// (body _zipf_kernel), whose wrappers pr_user_bit_kernel and
// pr_gc_bit_kernel give Pr(u <= u0 | v <= v0) and Pr(u <= g0 + r0 | u >= g0).
// Over a float32 pmf p, with (1-p)^e = exp(e * log1p(-p)):
//   out[0] = Σ p (1 - (1-p)^u0)(1 - (1-p)^v0)
//   out[1] = Σ p (1 - (1-p)^v0)
//   out[2] = Σ p (1-p)^g0
//   out[3] = Σ p ((1-p)^g0 - (1-p)^(g0+r0))
// g0 + r0 is added in float32, as the TPU kernel adds it. The library is
// built without fast math, so expf and log1pf are the full-precision
// versions: at exponents near 10^7 (the paper's 40 GiB) the fast
// approximations would lose the small terms the figures are made of.
// A zero p contributes 0, so the tail needs masking only, not padding.
//
// What bounds it on this card: memory, by the count below. It reads 4 bytes
// per element and does 22 float operations on it (counting log1pf and each
// of the four expf as one operation each): at the paper's n = 2,621,440 that
// is 10.5 MB, 3.1 us at 3.35 TB/s, against 0.9 us of operations at the
// 67 TFLOP/s float32 rate. Each expf and log1pf is in fact a sequence of
// instructions, so the kernel may well run nearer the operation side.
//
// Design: the TPU kernel carried the four sums in its output block across
// sequential grid steps. Blocks on this card run in parallel and share
// nothing, so a grid-stride loop gives each thread four float32 partial
// sums, a block reduction (warp shuffles, then shared memory) gives each
// block's four partials, which go to a scratch buffer, and a second launch
// of one block adds the partials up in a fixed order. No float atomics: the
// order of every addition depends only on n and the grid, so two launches on
// the same input give bit-identical sums.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}

// Sums each of s[0..3] over the block; thread 0 ends with the four totals.
__device__ __forceinline__ void block_sum4(float (&s)[4]) {
  __shared__ float part[4][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < 4; ++j) s[j] = warp_sum(s[j]);
  if (lane == 0) {
    for (int j = 0; j < 4; ++j) part[j][warp] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < 4; ++j) s[j] = warp_sum(lane < kWarps ? part[j][lane] : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
zipf_partials_kernel(const float* __restrict__ p, long long n, float u0, float v0, float g0,
                     float r0, float* __restrict__ partial) {
  const float gr = __fadd_rn(g0, r0);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    const float lg = log1pf(-pi);
    const float pow_u0 = expf(__fmul_rn(u0, lg));
    const float pow_v0 = expf(__fmul_rn(v0, lg));
    const float pow_g0 = expf(__fmul_rn(g0, lg));
    const float pow_gr = expf(__fmul_rn(gr, lg));
    const float not_v0 = __fsub_rn(1.0f, pow_v0);
    s[0] = __fadd_rn(s[0], __fmul_rn(__fmul_rn(pi, __fsub_rn(1.0f, pow_u0)), not_v0));
    s[1] = __fadd_rn(s[1], __fmul_rn(pi, not_v0));
    s[2] = __fadd_rn(s[2], __fmul_rn(pi, pow_g0));
    s[3] = __fadd_rn(s[3], __fmul_rn(pi, __fsub_rn(pow_g0, pow_gr)));
  }
  block_sum4(s);
  if (threadIdx.x == 0) {
    for (int j = 0; j < 4; ++j) partial[j * gridDim.x + blockIdx.x] = s[j];
  }
}

// One block: out[j] = the sum of partial[j * n_blocks .. (j + 1) * n_blocks).
__global__ void __launch_bounds__(kThreads)
zipf_total_kernel(const float* __restrict__ partial, int n_blocks, float* __restrict__ out) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
    for (int j = 0; j < 4; ++j) s[j] = __fadd_rn(s[j], partial[j * n_blocks + i]);
  }
  block_sum4(s);
  if (threadIdx.x == 0) {
    for (int j = 0; j < 4; ++j) out[j] = s[j];
  }
}

}  // namespace

// (n,) float32 pmf and four float32 exponents -> (4,) float32 sums.
// `partial` is scratch for 4 * max_blocks floats; the first launch uses at
// most max_blocks blocks. Launches on `stream`; returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int zipf_bit_sums_launch(const float* probs, long long n, float u0, float v0,
                                    float g0, float r0, float* partial, int max_blocks,
                                    float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long wanted = (n + kThreads - 1) / kThreads;
  const int n_blocks = static_cast<int>(wanted < max_blocks ? wanted : max_blocks);
  if (n_blocks > 0) {
    zipf_partials_kernel<<<n_blocks, kThreads, 0, s>>>(probs, n, u0, v0, g0, r0, partial);
  }
  zipf_total_kernel<<<1, kThreads, 0, s>>>(partial, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}
