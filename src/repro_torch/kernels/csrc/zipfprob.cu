// The four Zipf probability sums behind the paper's Figs 8 and 10, for a
// batch of points over one pmf in one launch.
//
// Replaces the TPU kernel in src/repro/kernels/zipfprob.py: zipf_bit_sums
// (body _zipf_kernel), whose wrappers pr_user_bit_kernel and
// pr_gc_bit_kernel give Pr(u <= u0 | v <= v0) and Pr(u <= g0 + r0 | u >= g0).
// Over a float32 pmf p, with (1-p)^e = exp(e * log1p(-p)), for each point
// (u0, v0, g0, r0) of the batch:
//   out[0] = Σ p (1 - (1-p)^u0)(1 - (1-p)^v0)
//   out[1] = Σ p (1 - (1-p)^v0)
//   out[2] = Σ p (1-p)^g0
//   out[3] = Σ p ((1-p)^g0 - (1-p)^(g0+r0))
// g0 + r0 is added in float32, as the TPU kernel adds it. The library is
// built without fast math, so expf and log1pf are the full-precision
// versions: at exponents near 10^7 (the paper's 40 GiB) the fast
// approximations would lose the small terms the figures are made of.
//
// What bounds it on this card: the instruction rate. A figure evaluates many
// points over one pmf of n = 2,621,440 floats (10.5 MB, 3.1 us at 3.35
// TB/s). Each element needs one full-precision log1pf (a polynomial, with
// a branch for special values), and each point two full-precision expf per
// element besides a dozen multiplies, adds and subtracts. A single point is
// thus bound by log1pf and the loads, a batch by the points' expf.
//
// Design:
// - One launch per batch of P points. Each block owns a fixed chunk of the
//   pmf (kChunk elements); each thread loads its kPerThread elements once,
//   computes lg = log1pf(-p) once, and keeps both in registers for every
//   point of the batch.
// - Work that gives a known value is skipped, exactly, in a block whose lg
//   are all finite (p < 1, as in a pmf): an expf whose exponent is ±0 is 1,
//   which is what expf(±0 * lg) returns for a finite lg; the sums whose
//   every term is then +0 stay 0 (s0 and s1 when u0 = v0 = 0, s3 when
//   g0 = g0 + r0 = 0); s2 at g0 = 0 is the thread's Σp, added in the same
//   order. At a Fig 8 point g0 = r0 = 0 and at a Fig 10 point u0 = v0 = 0,
//   so half of the expf go. A block that holds a p of 1 or more (lg = -inf
//   or NaN) skips nothing, so a zero exponent gives expf(NaN) = NaN there,
//   as the plain version does. The branches are uniform across the block.
// - Each point's four sums are reduced over the block (warp shuffles, then
//   the warps in order) after every kGroup points, and written to scratch
//   as partial[point][sum][block].
// - The block that finishes last (a __threadfence and a ticket on an int
//   counter) adds each row of partials in block order, each lane loading
//   kUnroll of its share at once, and writes out; it then resets the counter
//   for the next launch. No second launch, no memset, no float atomics.
// - The grid and the order of every addition depend on n alone, never on P
//   or on a point's place in the batch: a batch equals its points launched
//   one at a time bit for bit, and a repeat is bit-identical. 12 elements
//   a thread (64 registers, four blocks an SM) weighed the single point's
//   time against the batches'.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 12;                    // pmf elements a thread holds
constexpr int kChunk = kThreads * kPerThread;     // pmf elements a block owns
constexpr int kGroup = 16;                        // points between two block reductions
constexpr int kUnroll = 32;                       // partials in flight per lane in the total

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}

// pw[k] = (1 - p_k)^e = expf(e * lg[k]), or exactly 1 without an expf when
// e is ±0 and ``skip`` says the block's lg are finite (expf would return 1).
__device__ __forceinline__ void powers(float e, bool skip, const float (&lg)[kPerThread],
                                       float (&pw)[kPerThread]) {
  if (skip && e == 0.0f) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) pw[k] = 1.0f;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) pw[k] = expf(__fmul_rn(e, lg[k]));
  }
}

// The thread's share of one point's four sums, its elements added in order.
// Where ``skip`` says the block's lg are finite: a sum whose terms are all
// exactly +0 (s0 and s1 when u0 and v0 are 0, s3 when g0 and g0 + r0 are 0)
// stays 0, and s2 at g0 = 0 is the thread's Σp, added in the same order.
__device__ __forceinline__ void point_sums(const float (&p)[kPerThread],
                                           const float (&lg)[kPerThread], float sum_p, bool skip,
                                           float u0, float v0, float g0, float r0, float (&s)[4]) {
  float pw[kPerThread], a[kPerThread];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.0f;
  if (!skip || u0 != 0.0f || v0 != 0.0f) {
    powers(u0, skip, lg, pw);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) a[k] = __fmul_rn(p[k], __fsub_rn(1.0f, pw[k]));
    powers(v0, skip, lg, pw);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float not_v0 = __fsub_rn(1.0f, pw[k]);
      s[0] = __fadd_rn(s[0], __fmul_rn(a[k], not_v0));
      s[1] = __fadd_rn(s[1], __fmul_rn(p[k], not_v0));
    }
  }
  const float gr = __fadd_rn(g0, r0);
  if (!skip || g0 != 0.0f) {
    powers(g0, skip, lg, a);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) s[2] = __fadd_rn(s[2], __fmul_rn(p[k], a[k]));
    powers(gr, skip, lg, pw);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      s[3] = __fadd_rn(s[3], __fmul_rn(p[k], __fsub_rn(a[k], pw[k])));
    }
  } else {
    s[2] = sum_p;
    if (gr != 0.0f) {
      powers(gr, skip, lg, pw);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        s[3] = __fadd_rn(s[3], __fmul_rn(p[k], __fsub_rn(1.0f, pw[k])));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
zipf_batch_kernel(const float* __restrict__ probs, long long n, const float* __restrict__ exps,
                  int n_points, float* __restrict__ partial, int* __restrict__ ticket,
                  float* __restrict__ out) {
  __shared__ float part[4 * kGroup][kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_blocks = gridDim.x;

  // Every load is started before the first log1pf, whose special-case branch
  // would otherwise wait on each load in turn. In the last block a zero p
  // (past n) adds a zero to every sum: log1pf(-0) = -0, its powers are 1.
  float p[kPerThread], lg[kPerThread];
  const long long first = static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x;
  if (static_cast<long long>(blockIdx.x + 1) * kChunk <= n) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) p[k] = __ldg(probs + first + k * kThreads);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + static_cast<long long>(k) * kThreads;
      p[k] = i < n ? __ldg(probs + i) : 0.0f;
    }
  }
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    lg[k] = log1pf(-p[k]);
    finite = finite && isfinite(lg[k]);
  }
  const bool skip = __syncthreads_and(finite) != 0;
  float sum_p = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) sum_p = __fadd_rn(sum_p, p[k]);

  for (int base = 0; base < n_points; base += kGroup) {
    const int count = min(kGroup, n_points - base);
    for (int j = 0; j < count; ++j) {
      const float* e = exps + 4 * (base + j);
      float s[4];
      point_sums(p, lg, sum_p, skip, __ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3), s);
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = warp_sum(s[q]);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) part[4 * j + q][warp] = s[q];
      }
    }
    __syncthreads();
    if (threadIdx.x < 4 * count) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, part[threadIdx.x][w]);
      partial[(4LL * base + threadIdx.x) * n_blocks + blockIdx.x] = t;
    }
    __syncthreads();
  }

  // The last block to finish takes the totals.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == n_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = warp; r < 4 * n_points; r += kWarps) {
    const float* row = partial + static_cast<long long>(r) * n_blocks;
    float t = 0.0f;
    for (int b = lane; b < n_blocks; b += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = b + 32 * u;
        v[u] = i < n_blocks ? __ldcg(row + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) t = __fadd_rn(t, v[u]);
    }
    t = warp_sum(t);
    if (lane == 0) out[r] = t;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

long long blocks_for(long long n) { return n > 0 ? (n + kChunk - 1) / kChunk : 1; }

}  // namespace

// The launch shape for an (n,) pmf: grid[0] the elements a block owns,
// grid[1] the blocks, grid[2] the threads per block, grid[3] the points
// between two block reductions. The scratch a launch of P points needs is
// 4 * P * grid[1] floats.
extern "C" int zipf_bit_sums_grid(long long n, long long* grid) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  grid[0] = kChunk;
  grid[1] = blocks_for(n);
  grid[2] = kThreads;
  grid[3] = kGroup;
  return 0;
}

// (n,) float32 pmf and (P, 4) float32 exponents (u0, v0, g0, r0) -> (P, 4)
// float32 sums. `scratch` holds 4 * P * blocks floats; `ticket` is one int
// that is 0 before the launch, and the launch leaves it 0. Launches on
// `stream`; returns cudaGetLastError() so the caller can raise on a refused
// launch.
extern "C" int zipf_bit_sums_batch_launch(const float* probs, long long n, const float* exps,
                                          int n_points, float* scratch, int* ticket, float* out,
                                          void* stream) {
  const long long blocks = n < 0 ? 0 : blocks_for(n);
  if (blocks < 1 || blocks > INT_MAX || n_points < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  zipf_batch_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      probs, n, exps, n_points, scratch, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
