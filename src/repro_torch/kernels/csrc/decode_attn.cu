// Single-token GQA decode attention with an online softmax.
//
// Replaces the TPU kernel in src/repro/kernels/decode_attn.py: flash_decode
// (body _decode_kernel). q (B, Hq, D) attends over k, v (B, S, Hkv, D); the
// G = Hq / Hkv query heads of a KV head share its rows; positions at or past
// kv_len[b] are masked. Scores, the running max and denominator and the
// accumulator are float32; the output is stored in q's dtype (float32, or
// bfloat16 by round-to-nearest-even). Masked scores are -1e30, not -inf, as
// in the reference, so a masked position adds exactly 0 and nothing is
// inf - inf.
//
// What bounds it on this card: memory. Each KV row of a head is D values of
// K and D of V, and the G heads do 4 * G * D float operations on them: at
// qwen3-32b's G = 8 that is 8 operations per bf16 byte, far below the 295
// the card's tensor cores need per byte, and 4 per float32 byte against the
// 20 of its float32 rate. The least time is the K and V rows up to kv_len
// over 3.35 TB/s.
//
// Design: the TPU kernel walked the KV tiles of one (batch row, KV head) in
// sequential grid steps, with the running max, denominator and accumulator
// in VMEM scratch. Here one thread block owns a (batch row, KV head) and
// loops over its KV history up to kv_len[b] itself, in tiles of kTile rows
// staged in shared memory as float32 (K rows padded to D + 1 floats, so the
// threads of a warp read distinct banks). Per tile: the (G, kTile) scores,
// one thread per score; the online-softmax update, one warp per query head;
// then acc = alpha * acc + p @ V, one thread per accumulator element. The
// scaled q, the accumulator and the running statistics stay in shared
// memory for the whole loop. G needs no padding (the TPU kernel padded it to
// 8 sublanes), and the ragged last tile is masked, not padded. This is the
// simple form: no tensor cores, no split of the KV axis across blocks (B *
// Hkv blocks may leave SMs idle), no overlap of loads with compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // KV rows per shared-memory tile: two per lane
constexpr float kMasked = -1e30f;   // the reference's mask value
constexpr int kMaxSharedBytes = 232448;   // what one block may use on Hopper

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared memory in floats: q and acc (G, D) each, K (kTile, D + 1), V
// (kTile, D), scores (G, kTile), and m, l, alpha (G) each.
size_t shared_bytes(int G, int D) {
  const size_t floats = 2 * static_cast<size_t>(G) * D + static_cast<size_t>(kTile) * (D + 1) +
                        static_cast<size_t>(kTile) * D + static_cast<size_t>(G) * kTile + 3 * G;
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kv_len, int S, int Hkv, int G, int D, float scale,
              T* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* k_s = acc_s + G * D;
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * D;
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int len = min(kv_len[b], S);
  const size_t head_off = (static_cast<size_t>(b) * Hkv + h) * G * D;   // q and out rows
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    q_s[i] = __fmul_rn(to_float(q[head_off + i]), scale);
    acc_s[i] = 0.0f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.0f;
  }
  const size_t row_stride = static_cast<size_t>(Hkv) * D;   // one position to the next
  const size_t kv_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int rows = min(kTile, len - t0);
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const size_t off = kv_off + static_cast<size_t>(t0 + r) * row_stride + c;
      k_s[r * (D + 1) + c] = to_float(k[off]);
      v_s[r * D + c] = to_float(v[off]);
    }
    __syncthreads();   // the tile (and, on the first pass, q and the statistics) is in

    for (int i = threadIdx.x; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int r = i - g * kTile;
      float score = kMasked;
      if (r < rows) {
        const float* qg = q_s + g * D;
        const float* kr = k_s + r * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
        score = dot;
      }
      p_s[i] = score;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTile;
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = expf(s0 - m_new);
      const float e1 = expf(s1 - m_new);
      float sum = e0 + e1;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = e0;
      row[lane + 32] = e1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = fmaf(alpha, l_s[g], sum);
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * kTile;
      float a = 0.0f;
      for (int r = 0; r < rows; ++r) a = fmaf(pg[r], v_s[r * D + d], a);
      acc_s[i] = fmaf(alpha_s[g], acc_s[i], a);
    }
    __syncthreads();   // before the next tile overwrites K, V and the scores
  }

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    store(out + head_off + i, acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len, int B, int S,
           int Hkv, int G, int D, float scale, void* out, cudaStream_t stream) {
  static bool opted_in = false;   // above 48 KB of shared memory only after this
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const size_t smem = shared_bytes(G, D);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && Hkv > 0) {
    decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
        S, Hkv, G, D, scale, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv * G, D), k and v (B, S, Hkv, D), all contiguous, of one dtype
// (0 float32, 1 bfloat16); kv_len (B,) int32, each >= 1 -> out (B, Hkv * G,
// D) in the same dtype. `scale` multiplies q (1 / sqrt(D)). Launches on
// `stream`; returns a CUDA error code (0 on success) so the caller can raise.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* kv_len, int B, int S, int Hkv, int G, int D,
                                   int dtype, float scale, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, kv_len, B, S, Hkv, G, D, scale, out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, kv_len, B, S, Hkv, G, D, scale, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
