// Single-token GQA decode attention as a split-KV flash-decode.
//
// Replaces the TPU kernel in src/repro/kernels/decode_attn.py: flash_decode
// (body _decode_kernel). q (B, Hq, D) attends over k, v (B, S, Hkv, D); the
// G = Hq / Hkv query heads of a KV head share its rows; positions at or past
// kv_len[b] are masked. Scores, the running max and denominator and the
// accumulator are float32; the output is stored in q's dtype (float32, or
// bfloat16 by round-to-nearest-even). A masked score is -1e30 in the
// reference and adds exactly 0 to its softmax, so here masked rows are
// simply not read.
//
// What bounds it on this card: bytes. Each KV row of a head is D values of
// K and D of V, and the G query heads do 2 * G * D fused multiply-adds on
// them: at qwen3-32b's G = 8 that is 4 float32 FMAs (8 flops) per bf16 byte,
// at starcoder2-3b's G = 12 six. The CUDA cores give about 10 FMAs per byte
// of device-memory bandwidth (33.5 T FMA/s over 3.35 TB/s), so they can keep
// up with memory at every geometry taken here: no tensor cores are needed.
// The least time is the K and V rows up to kv_len over 3.35 TB/s.
//
// Why the KV axis is split: with one block per (batch row, KV head), as the
// TPU kernel's sequential grid suggests, the longest head (8192 rows, 4.2 MB
// of bf16 K and V at qwen3-32b) streams through one SM, whose share of the
// card's bandwidth is about 25 GB/s: 168 us at best. Here pass 1 gives one
// block to each (KV head and tile of query heads, chunk of rows, batch row),
// sized from S so that the launch reads nothing from the device; a block
// whose chunk starts at or past kv_len[b] exits at once. The KV heads of a
// chunk are neighbours in the grid, so blocks in flight together read
// neighbouring bytes. Latency is hidden by the blocks in flight and one
// step of loads ahead in each warp, not by an asynchronous copy pipeline.
//
// Inside a pass-1 block, four warps take the chunk's rows in turn, with no
// __syncthreads in the row loop. L lanes (8 for D = 64, 16 for D = 96 and
// 128, of which 12 hold data at 96, 32 for D = 256) cover one row, 8 values
// each, read with 16-byte loads, neighbouring lanes on neighbouring
// addresses, straight into registers; a step's rows are used while the next
// step's are in flight. Up to D = 128 a lane keeps at most 4 query heads
// (kLaneHeads) in registers, pre-scaled, with their accumulators: a tile of
// 8 heads is two lane groups that read the same rows, so K and V leave
// memory once for the tile and the warp needs ~124 registers a lane (4
// blocks per SM) instead of ~200 (2 blocks). At D = 256 a row fills the
// warp, so there is no second lane group: a lane keeps all the tile's heads
// (8 at most, 8 values of q and of acc for each) and takes one row per
// step (kLaneRows256), at up to ~200 registers (2 blocks per SM); the
// merge's shared memory is then 32 KB, under the 48 KB static limit.
// Below D = 256 each lane group takes 2 rows per step (kLaneRows): their 8
// dot products per lane are fmaf chains, then a reduce-scatter butterfly
// across the row's lanes leaves each lane one finished (row, head) score,
// so one shuffle tree and one expf per lane serve 2 rows. Each warp keeps
// its own online softmax, and rescales its accumulator only when a score
// passes the running max by more than kRescaleAbove (exp(s - m) stays <=
// e^8), not once per row or group of rows. At the end of the chunk the warps are merged
// once through shared memory, and the block writes its partial
// (m, l, acc[D]) per query head in float32.
//
// Pass 2 gives one block to each (batch row, query head). It reads exactly
// the ceil(min(kv_len, S) / chunk) partials that pass 1 wrote, in chunk
// order: M = max m_i, out = sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i,
// 1e-30). No float atomics: a repeat on the same input is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;              // KV rows of a pass-1 block
constexpr int kMaxTile = 8;              // query heads of a pass-1 block, at most
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                  // values of a row in one lane
constexpr float kMasked = -1e30f;        // the reference's mask value
constexpr float kRescaleAbove = 8.0f;    // the lazy rescale's margin, in nats
constexpr int kLaneHeads = 4;           // query heads of one lane, at most, below D = 256
constexpr int kLaneRows = 2;            // rows a lane group takes per step, at most
constexpr int kLaneRows256 = 1;         // the same at D = 256, where a lane holds 8 heads
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// A row fills the warp (D = 256): one lane group, holding the whole tile.
template <int D> constexpr bool kWideRow = D / kVec > 16;
// Blocks of the split pass per SM that its registers must allow: 4 (at most
// 128 registers) in bf16, 3 in float32, whose rows take twice the registers;
// 2 at D = 256, where a lane holds up to 8 heads. Naming them also keeps
// ptxas from trading registers for spills.
template <typename T, int D>
constexpr int kMinBlocks = kWideRow<D> ? 2 : (sizeof(T) == 2 ? 4 : 3);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A lane's 8 values of one row, as loaded: one 16-byte load of bf16, or
// two of float32 (elements 4j.. and D/2 + 4j.., so that each load
// instruction reads neighbouring addresses across the lanes).
template <typename T> struct Row;
template <> struct Row<__nv_bfloat16> { uint4 a; };
template <> struct Row<float> { float4 a, b; };

template <int D>
__device__ __forceinline__ Row<__nv_bfloat16> load_row(const __nv_bfloat16* row, int j) {
  return {__ldg(reinterpret_cast<const uint4*>(row) + j)};
}
template <int D>
__device__ __forceinline__ Row<float> load_row(const float* row, int j) {
  return {__ldg(reinterpret_cast<const float4*>(row) + j),
          __ldg(reinterpret_cast<const float4*>(row + D / 2) + j)};
}

__device__ __forceinline__ void to_floats(const Row<__nv_bfloat16>& r, float (&f)[kVec]) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // the lower half of a word is the earlier value
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_floats(const Row<float>& r, float (&f)[kVec]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}

// The element of a row that lane j holds in its slot e (the load's layout).
template <typename T, int D>
__device__ __forceinline__ int element(int j, int e) {
  if (sizeof(T) == 2) return kVec * j + e;
  return e < 4 ? 4 * j + e : D / 2 + 4 * j + (e - 4);
}

// Lanes that hold one row: a power of two, D / 8 of them with data.
template <int D> __host__ __device__ constexpr int row_lanes() {
  return D / kVec <= 8 ? 8 : (D / kVec <= 16 ? 16 : 32);
}
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Sum each of the N partial dot products across the row's L lanes (N <= L).
// While a lane holds two or more it keeps half and sends half to its
// partner; once one is left, the pair adds. Lane j ends with the sum of
// product j / (L / N).
template <int N, int L>
__device__ __forceinline__ float butterfly(float (&part)[N], int j) {
  constexpr int kLevels = log2i(L);
#pragma unroll
  for (int s = 0; s < kLevels; ++s) {
    const int o = L >> (s + 1);
    const int held = N >> s;
    if (held >= 2) {
      const int half = held / 2;
      const bool upper = (j & o) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float lo = part[i], hi = part[i + half];
        const float got = __shfl_xor_sync(kFull, upper ? lo : hi, o);
        part[i] = (upper ? hi : lo) + got;
      }
    } else {
      part[0] += __shfl_xor_sync(kFull, part[0], o);
    }
  }
  return part[0];
}

// Pass 1: the partial of one chunk of rows for GT query heads of a KV head.
// Partials: per (b, query head, chunk) D + 2 floats, [m, l, acc[0..D)].
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kv_len, int S, int Hkv, int G, int tiles, float scale,
             float* __restrict__ part) {
  constexpr int L = row_lanes<D>();
  constexpr int kHeads = kWideRow<D> ? GT : kLaneHeads;
  constexpr int GL = GT < kHeads ? GT : kHeads;   // query heads of one lane
  constexpr int kHeadGroups = GT / GL;       // lane groups that read the same rows
  constexpr int kGroups = 32 / L / kHeadGroups;   // lane groups on other rows
  static_assert(kGroups >= 1, "a warp holds a lane group for every head group");
  constexpr int kRows = kWideRow<D> ? kLaneRows256 : kLaneRows;
  constexpr int R = kRows < L / GL ? kRows : L / GL;   // rows of a group's step
  constexpr int kScores = R * GL;            // scores of a group's step, <= L
  constexpr int kSpread = L / kScores;       // lanes that end with one score
  constexpr int kStep = kWarps * kGroups * R;   // rows the block takes per step
  constexpr int kRowLanes = L * kHeadGroups;    // lanes of one row, all heads
  __shared__ float acc_s[kWarps][GT][D];
  __shared__ float m_s[kWarps][GT];
  __shared__ float l_s[kWarps][GT];

  const int c = blockIdx.y;
  const int h = blockIdx.x / tiles;
  const int g0 = (blockIdx.x - h * tiles) * GT;
  const int b = blockIdx.z;
  const int len = min(kv_len[b], S);
  const int r0 = c * kChunk;
  if (r0 >= len) return;                     // a chunk past kv_len writes nothing
  const int r_end = min(r0 + kChunk, len);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / L;                  // lane group: rows rg, heads hg
  const int hg = grp % kHeadGroups;
  const int rg = grp / kHeadGroups;
  const int j = lane % L;
  const bool holds = j < D / kVec;           // false for lanes 12..15 at D = 96
  const int mine = j / kSpread;              // the score this lane ends with:
  const int my_row = mine / GL;              //   row my_row of the step,
  const int my_head = mine - my_row * GL;    //   head my_head of the lane group
  const int Hq = Hkv * G;
  const int gl0 = g0 + hg * GL;              // the lane group's first query head
  const int gn = min(GL, G - gl0);           // its heads that exist

  float qr[GL][kVec];
  const T* qh = q + (static_cast<size_t>(b) * Hq + h * G + gl0) * D;
#pragma unroll
  for (int g = 0; g < GL; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      qr[g][e] = holds && g < gn ? __fmul_rn(to_float(qh[g * D + element<T, D>(j, e)]), scale)
                                 : 0.0f;
    }
  }
  float acc[GL][kVec];
#pragma unroll
  for (int g = 0; g < GL; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.0f;
  }
  float m = kMasked;   // running max of head my_head
  float l = 0.0f;      // its denominator over this lane's rows (my_row of each step)

  const size_t row_stride = static_cast<size_t>(Hkv) * D;   // one position to the next
  const size_t head_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  const T* kh = k + head_off;
  const T* vh = v + head_off;
  // The group's rows of a step are s + rg * R + r, r < R; rows past the end
  // are read clamped and masked.
  const int first = r0 + warp * kGroups * R;
  Row<T> kr[R], vr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kr[r] = {};
    vr[r] = {};
    if (holds) {
      const size_t off = static_cast<size_t>(min(first + rg * R + r, r_end - 1)) * row_stride;
      kr[r] = load_row<D>(kh + off, j);
      vr[r] = load_row<D>(vh + off, j);
    }
  }
  for (int s = first; s < r_end; s += kStep) {   // s is warp-uniform
    const int next = s + kStep;
    // This step's rows; the next step's are loaded into kr and vr meanwhile.
    Row<T> kc[R], vc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kc[r] = kr[r];
      vc[r] = vr[r];
    }
    if (holds && next < r_end) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t off = static_cast<size_t>(min(next + rg * R + r, r_end - 1)) * row_stride;
        kr[r] = load_row<D>(kh + off, j);
        vr[r] = load_row<D>(vh + off, j);
      }
    }
    float dots[kScores];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[kVec];
      to_floats(kc[r], x);
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qr[g][e], x[e], dot);
        dots[r * GL + g] = dot;
      }
    }
    const float score = butterfly<kScores, L>(dots, j);
    const bool valid = s + rg * R + my_row < r_end;
    float mx = valid ? score : kMasked;
#pragma unroll
    for (int o = GL * kSpread; o < L; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
#pragma unroll
    for (int o = kRowLanes; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    if (__any_sync(kFull, mx > m + kRescaleAbove)) {
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        const float a = __shfl_sync(kFull, alpha, grp * L + g * kSpread);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] *= a;
      }
    }
    const float p = valid ? expf(score - m) : 0.0f;
    l += p;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[kVec];
      to_floats(vc[r], x);
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        const float pg = __shfl_sync(kFull, p, grp * L + (r * GL + g) * kSpread);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(pg, x[e], acc[g][e]);
      }
    }
  }

  // The lanes of a head share m; add their l (over the step's rows, then
  // the lane groups) and acc (over the lane groups), then merge the warps.
#pragma unroll
  for (int o = GL * kSpread; o < L; o <<= 1) l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
  for (int o = kRowLanes; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
    for (int g = 0; g < GL; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }
  }
  if (rg == 0) {
    if (my_row == 0 && j % kSpread == 0) {
      m_s[warp][hg * GL + my_head] = m;
      l_s[warp][hg * GL + my_head] = l;
    }
    if (holds) {
#pragma unroll
      for (int g = 0; g < GL; ++g) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc_s[warp][hg * GL + g][element<T, D>(j, e)] = acc[g][e];
        }
      }
    }
  }
  __syncthreads();
  const int tile_n = min(GT, G - g0);
  if (threadIdx.x < tile_n) {                // each head's warp weights, once
    const int g = threadIdx.x;
    float M = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][g]);
    float den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {      // a warp with no rows has m = -1e30: weight 0
      const float e = expf(m_s[w][g] - M);
      m_s[w][g] = e;
      den = fmaf(e, l_s[w][g], den);
    }
    l_s[0][g] = M;
    l_s[1][g] = den;
  }
  __syncthreads();
  const int chunks = gridDim.y;
  for (int i = threadIdx.x; i < tile_n * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(m_s[w][g], acc_s[w][g][d], a);
    float* dst = part + ((static_cast<size_t>(b) * Hq + h * G + g0 + g) * chunks + c) * (D + 2);
    dst[2 + d] = a;
    if (d == 0) {
      dst[0] = l_s[0][g];
      dst[1] = l_s[1][g];
    }
  }
}

// Pass 2: one block per (query head, batch row) adds the live partials in
// chunk order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ part, const int* __restrict__ kv_len, int S, int D,
               int chunks, T* __restrict__ out) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = gridDim.x;
  const int live = (min(kv_len[b], S) + kChunk - 1) / kChunk;
  const float* p = part + (static_cast<size_t>(b) * Hq + hq) * chunks * (D + 2);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float M = kMasked;
#pragma unroll 8
    for (int c = 0; c < live; ++c) M = fmaxf(M, p[c * (D + 2)]);
    float a = 0.0f, den = 0.0f;
#pragma unroll 8
    for (int c = 0; c < live; ++c) {         // unrolled, so that the loads overlap
      const float* pc = p + c * (D + 2);
      const float e = expf(pc[0] - M);
      a = fmaf(e, pc[2 + d], a);
      den = fmaf(e, pc[1], den);
    }
    store(out + (static_cast<size_t>(b) * Hq + hq) * D + d, a / fmaxf(den, 1e-30f));
  }
}

// The launch's shape for a history of S rows and G query heads per KV head:
// blocks along S, query heads per block (the power of two at least G, at
// most kMaxTile) and blocks per KV head.
struct Grid {
  int chunks, tile, tiles;
};

Grid grid_of(int S, int G) {
  int tile = 1;
  while (tile < G && tile < kMaxTile) tile *= 2;
  return {(S + kChunk - 1) / kChunk, tile, (G + tile - 1) / tile};
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  int B, S, Hkv, G, D;
  float scale;
  float* part;
  void* out;
  cudaStream_t stream;
};

template <typename T, int D, int GT>
int launch(const Args& a, const Grid& g) {
  if (g.chunks > 65535 || a.B > 65535 || a.Hkv * a.G > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_kernel<T, D, GT><<<dim3(a.Hkv * g.tiles, g.chunks, a.B), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_len, a.S, a.Hkv, a.G, g.tiles, a.scale, a.part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T><<<dim3(a.Hkv * a.G, a.B), kCombineThreads, 0, a.stream>>>(
      a.part, a.kv_len, a.S, D, g.chunks, static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_tile(const Args& a) {
  const Grid g = grid_of(a.S, a.G);
  switch (g.tile) {
    case 1: return launch<T, D, 1>(a, g);
    case 2: return launch<T, D, 2>(a, g);
    case 4: return launch<T, D, 4>(a, g);
    case 8: return launch<T, D, 8>(a, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_dim(const Args& a) {
  switch (a.D) {
    case 64: return by_tile<T, 64>(a);
    case 96: return by_tile<T, 96>(a);
    case 128: return by_tile<T, 128>(a);
    case 256: return by_tile<T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launch's shape, for the caller to size the scratch and report the
// grid: grid[0..6) = KV rows of a pass-1 block, pass-1 blocks along S,
// query heads of a pass-1 block, blocks per KV head, threads of a pass-1
// block, and the floats of float32 scratch that `part` must hold.
extern "C" int flash_decode_grid(int B, int S, int Hkv, int G, int D, long long* grid) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g = grid_of(S, G);
  grid[0] = kChunk;
  grid[1] = g.chunks;
  grid[2] = g.tile;
  grid[3] = g.tiles;
  grid[4] = kThreads;
  grid[5] = static_cast<long long>(B) * Hkv * G * g.chunks * (D + 2);
  return 0;
}

// q (B, Hkv * G, D), k and v (B, S, Hkv, D), all contiguous and 16-byte
// aligned, of one dtype (0 float32, 1 bfloat16); kv_len (B,) int32, each
// >= 1 -> out (B, Hkv * G, D) in the same dtype. `scale` multiplies q
// (1 / sqrt(D)); `part` is float32 scratch of the size flash_decode_grid
// reports. Two launches on `stream`; returns a CUDA error code (0 on
// success) so the caller can raise.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* kv_len, int B, int S, int Hkv, int G, int D,
                                   int dtype, float scale, void* part, void* out, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, kv_len, B, S, Hkv, G, D, scale, static_cast<float*>(part), out,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_dim<float>(a);
  if (dtype == 1) return by_dim<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
