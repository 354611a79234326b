// The nine stateful placement schemes inside the replay kernel (replay.cu's
// kStateful instance): per scheme, the class of a user write, which reads
// and updates the written LBA's table entries, and the classes of a GC
// victim's live slots.
//
// The formulas and their order of operations are those of the plain
// version, core/placement/stateful.py and its twin of the shared
// classifiers, core/placement/temperature_shared.py (the JAX package's
// placement/jax_schemes.py and temperature_shared.py): every float op is a
// round-to-nearest intrinsic and the build has no fused multiply-add, so
// the sch_* tables end bit-equal to the step engine's.
//
// Every function is called by all 32 lanes of the volume's warp with the
// same arguments; lane 0 does the writes, after a __syncwarp that orders
// them behind every lane's reads. The per-volume scalars (`Scalars`) live
// once per warp in shared memory: every lane reads them, lane 0 writes
// them. The per-volume reductions (eti's mean of its extent counters, sfs's
// quantiles of the seen LBAs' hotness) run over the volume's own entries,
// lane j taking entries j, j + 32, ...

#pragma once

#include <cmath>

namespace stateful_ops {

// dense scheme ids (core/placement/schemes.py)
constexpr int kFk = 3, kDac = 4, kMl = 5, kSfs = 6, kEti = 9, kMq = 10, kSfr = 11,
              kFadac = 12, kWarcip = 13;
constexpr int kClasses = 6;          // classes of fk, dac, ml and sfs
constexpr int kNoBit = 1 << 30;      // fk's "no next write"
constexpr int kEtiExtent = 256;      // temperature_shared's constants
constexpr int kEtiDecayShift = 15;   // one halving per 2^15 writes
constexpr int kChunk = 64;           // sfr's and fadac's chunk
constexpr int kFadacHalfLifeShift = 16;
constexpr int kCentroids = 5;        // warcip
constexpr int kBounds = kClasses - 1;   // sfs's quantile bounds
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;   // +inf: an unseen LBA's hotness

__device__ __forceinline__ bool is_stateful(int scheme) {
  return scheme == kFk || scheme == kDac || scheme == kMl || scheme == kSfs || scheme >= kEti;
}

// One volume's tables (pointers to its row of each (V, ...) sch_* key).
struct Tables {
  int* fk_bit;
  int* dac_region;
  int* ml_count;
  int* ml_level;
  int* sfs_count;
  int* sfs_first;
  unsigned* sfs_keys;   // (n_lbas,) scratch of the quantile refresh
  int* eti_count;
  int* eti_last;
  int* mq_freq;
  int* mq_level;
  int* mq_expire;
  float* sfr_freq;
  int* sfr_last;
  int* fadac_count;
  int* fadac_last;
  int* warcip_last;
  int n_lbas;
  int n_ext;            // eti's extents: ceil(n_lbas / 256)
  int seg_size;
  int sfs_resample;
};

// One volume's scalar state, in the warp's shared memory for the whole replay.
struct Scalars {
  int sfs_since;
  bool sfs_ready;
  float sfs_bounds[kBounds];
  int sfr_prev;
  float warcip_cent[kCentroids];
  float warcip_cnt[kCentroids];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_diff(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kAll, x, off);
  return x;
}

// -- temperature_shared's helpers ------------------------------------------------

// floor(log2(x)) for x >= 1, 0 below: the count of the powers 2^1 .. 2^30 x reaches
__device__ __forceinline__ int ilog2(int x) { return x >= 2 ? 31 - __clz(x) : 0; }

// piecewise-linear log2(x) = f + x / 2^f - 1, the quotient exact
__device__ __forceinline__ float log2_interp(int x) {
  const int f = ilog2(x);
  const float pow2 = __int2float_rn(1 << f);
  return __fsub_rn(__fadd_rn(__int2float_rn(f), __fdiv_rn(__int2float_rn(x), pow2)), 1.0f);
}

// 5 - min(floor(log2(1 + temp)), 5) by the thresholds 1, 3, 7, 15, 31
__device__ __forceinline__ int fadac_class(int temp) {
  const int lvl = (temp >= 1) + (temp >= 3) + (temp >= 7) + (temp >= 15) + (temp >= 31);
  return clampi(5 - lvl, 0, 5);
}

// a fading counter read at `now`: one halving per whole half-life since `last`
__device__ __forceinline__ int fadac_fold(int count, int last, int now) {
  const int periods = max(wrap_diff(now, last), 0) >> kFadacHalfLifeShift;
  return count >> clampi(periods, 0, 31);
}

// -- fk, dac, ml ----------------------------------------------------------------

// ceil(remaining lifespan / segment size) - 1 in 0..5; 5 for no next write
__device__ __forceinline__ int fk_class(int next, int t, int s) {
  if (next >= kNoBit) return kClasses - 1;
  const int remaining = max(wrap_diff(next, t), 1);
  return clampi((remaining + s - 1) / s - 1, 0, kClasses - 1);
}

// -- sfs ------------------------------------------------------------------------

__device__ __forceinline__ float sfs_hotness(int count, int first, int t) {
  return __fdiv_rn(__int2float_rn(count), __int2float_rn(max(wrap_diff(t, first), 1)));
}

// jnp.searchsorted(bounds, h), side "left": JAX's binary search of
// ceil(log2(6)) = 3 halvings, step for step
__device__ __forceinline__ int searchsorted_left(const float* b, float h) {
  bool left = h <= b[kBounds / 2];
  int low = left ? 0 : kBounds / 2, high = left ? kBounds / 2 : kBounds;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int mid = (low + high) / 2;
    left = h <= b[mid];
    low = left ? low : mid;
    high = left ? mid : high;
  }
  return high;
}

__device__ __forceinline__ int sfs_class(const Scalars& sc, float h) {
  return sc.sfs_ready ? clampi(kClasses - 1 - searchsorted_left(sc.sfs_bounds, h), 0,
                               kClasses - 1)
                      : 0;
}

// The quantile refresh (stateful._sfs_bounds): the bounds at positions
// i / 6 * (k - 1) of the k seen LBAs' hotness, sorted, with linear
// interpolation. Needs only 10 order statistics of the hotness (float32 >=
// 0, whose bits order as unsigned integers; +inf where unseen), found
// exactly by a bitwise descent over the keys for all 10 ranks at once: at
// each bit from the top, a rank's answer keeps the bit at 0 when enough keys
// lie at or below the answer with the bit 0 and every lower bit 1. Every
// lane computes the bounds; lane 0 stores them, and the warp syncs before
// it returns. Not inlined: its 30-odd live values stay out of the hot loop's
// register budget (a refresh runs once per sfs_resample writes); it takes
// its tables as pointers, so no caller keeps a `Tables` in local memory.
__device__ __noinline__ void sfs_refresh(const int* sfs_first, const int* sfs_count,
                                         unsigned* sfs_keys, int n_lbas, Scalars& sc, int t,
                                         int lane) {
  int seen = 0;
  for (int j = lane; j < n_lbas; j += 32) {
    const int first = sfs_first[j];
    const bool is_seen = first >= 0;
    sfs_keys[j] = is_seen ? __float_as_uint(sfs_hotness(sfs_count[j], first, t)) : kInfBits;
    seen += is_seen ? 1 : 0;
  }
  const int kk = warp_sum(seen);
  __syncwarp();
  if (kk < kClasses) return;

  // the positions i * f32(1/6) * (k - 1) in float32, their floor, ceil and
  // fraction (the quantile factors as XLA folds i / 6)
  const float km1 = __int2float_rn(kk - 1);
  const float sixth = __fdiv_rn(1.0f, static_cast<float>(kClasses));
  float frac[kBounds];
  int rank[2 * kBounds];
#pragma unroll
  for (int i = 0; i < kBounds; ++i) {
    const float q = __fmul_rn(__fmul_rn(static_cast<float>(i + 1), sixth), km1);
    const float lo = floorf(q), hi = ceilf(q);
    frac[i] = __fsub_rn(q, lo);
    rank[2 * i] = static_cast<int>(lo);
    rank[2 * i + 1] = static_cast<int>(hi);
  }
  unsigned ans[2 * kBounds];
#pragma unroll
  for (int r = 0; r < 2 * kBounds; ++r) ans[r] = 0u;
  for (int bit = 30; bit >= 0; --bit) {     // bit 31 (the sign) is 0 in every key
    const unsigned low_ones = (1u << bit) - 1u;
    int below[2 * kBounds];
#pragma unroll
    for (int r = 0; r < 2 * kBounds; ++r) below[r] = 0;
    for (int j = lane; j < n_lbas; j += 32) {
      const unsigned key = sfs_keys[j];
#pragma unroll
      for (int r = 0; r < 2 * kBounds; ++r) below[r] += key <= (ans[r] | low_ones) ? 1 : 0;
    }
#pragma unroll
    for (int r = 0; r < 2 * kBounds; ++r) {
      if (warp_sum(below[r]) <= rank[r]) ans[r] |= 1u << bit;
    }
  }
  // hs[hi] * frac + hs[lo] * (1 - frac) with one rounding of the fused
  // product and sum, in float64 (the product of two float32 is exact there)
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kBounds; ++i) {
      const float lo_v = __uint_as_float(ans[2 * i]), hi_v = __uint_as_float(ans[2 * i + 1]);
      const float c = __fmul_rn(lo_v, __fsub_rn(1.0f, frac[i]));
      sc.sfs_bounds[i] = __double2float_rn(__dadd_rn(
          __dmul_rn(static_cast<double>(hi_v), static_cast<double>(frac[i])),
          static_cast<double>(c)));
    }
    sc.sfs_ready = true;
  }
  __syncwarp();
}

// -- eti ------------------------------------------------------------------------

__device__ __forceinline__ int eti_fold(int count, int last_epoch, int epoch) {
  return count >> clampi(wrap_diff(epoch, last_epoch), 0, 31);
}

// -- warcip ---------------------------------------------------------------------

__device__ __forceinline__ float warcip_interval(int dt) { return log2_interp(max(dt, 1) + 1); }

// -- the per-volume state ---------------------------------------------------------

__device__ __forceinline__ void load_scalars(int scheme, const int* since,
                                             const unsigned char* ready, const float* bounds,
                                             const int* prev, const float* cent, const float* cnt,
                                             Scalars& sc) {
  sc.sfs_since = 0;
  sc.sfs_ready = false;
  sc.sfr_prev = 0;
#pragma unroll
  for (int i = 0; i < kBounds; ++i) sc.sfs_bounds[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kCentroids; ++i) {
    sc.warcip_cent[i] = 0.0f;
    sc.warcip_cnt[i] = 0.0f;
  }
  if (scheme == kSfs) {
    sc.sfs_since = *since;
    sc.sfs_ready = *ready != 0;
#pragma unroll
    for (int i = 0; i < kBounds; ++i) sc.sfs_bounds[i] = bounds[i];
  } else if (scheme == kSfr) {
    sc.sfr_prev = *prev;
  } else if (scheme == kWarcip) {
#pragma unroll
    for (int i = 0; i < kCentroids; ++i) {
      sc.warcip_cent[i] = cent[i];
      sc.warcip_cnt[i] = cnt[i];
    }
  }
}

__device__ __forceinline__ void store_scalars(int scheme, const Scalars& sc, int* since,
                                              unsigned char* ready, float* bounds, int* prev,
                                              float* cent, float* cnt) {
  if (scheme == kSfs) {
    *since = sc.sfs_since;
    *ready = sc.sfs_ready ? 1 : 0;
#pragma unroll
    for (int i = 0; i < kBounds; ++i) bounds[i] = sc.sfs_bounds[i];
  } else if (scheme == kSfr) {
    *prev = sc.sfr_prev;
  } else if (scheme == kWarcip) {
#pragma unroll
    for (int i = 0; i < kCentroids; ++i) {
      cent[i] = sc.warcip_cent[i];
      cnt[i] = sc.warcip_cnt[i];
    }
  }
}

// -- user writes (stateful.user_classes) -------------------------------------------

// The class of a user write of `lba` at time `t` (before the write) under a
// stateful `scheme`, updating the scheme's tables and the warp's scalars
// `sc` (shared memory) as the step engine does; `next` is fk's next-write
// index of this write. Every lane calls it; it returns behind a __syncwarp,
// so the next reads of `sc` see its writes.
__device__ __forceinline__ int user_class(int scheme, const Tables& tb, Scalars& sc, int lba,
                                          int t, int next, int lane) {
  int cls = 0;
  switch (scheme) {
    case kFk: {
      __syncwarp();
      if (lane == 0) tb.fk_bit[lba] = next;
      cls = fk_class(next, t, tb.seg_size);
      break;
    }
    case kDac: {
      const int r = clampi(tb.dac_region[lba] + 1, 1, kClasses - 1);
      __syncwarp();
      if (lane == 0) tb.dac_region[lba] = r;
      cls = kClasses - 1 - r;
      break;
    }
    case kMl: {
      const int c = tb.ml_count[lba] + 1;
      const int lvl = (c >= 2) + (c >= 4) + (c >= 8) + (c >= 16) + (c >= 32);
      __syncwarp();
      if (lane == 0) {
        tb.ml_count[lba] = c;
        tb.ml_level[lba] = lvl;
      }
      cls = kClasses - 1 - lvl;
      break;
    }
    case kSfs: {
      const int f0 = tb.sfs_first[lba];
      const int f1 = f0 < 0 ? t : f0;
      const int c1 = tb.sfs_count[lba] + 1;
      const int since = sc.sfs_since + 1;
      __syncwarp();
      if (lane == 0) {
        tb.sfs_first[lba] = f1;
        tb.sfs_count[lba] = c1;
      }
      __syncwarp();   // the refresh reads the tables with this write in them
      const bool tick = since >= tb.sfs_resample;
      if (tick) {   // stores the bounds, then syncs
        sfs_refresh(tb.sfs_first, tb.sfs_count, tb.sfs_keys, tb.n_lbas, sc, t, lane);
      }
      if (lane == 0) sc.sfs_since = tick ? 0 : since;
      cls = sfs_class(sc, sfs_hotness(c1, f1, t));
      break;
    }
    case kEti: {
      const int e = lba / kEtiExtent;
      const int before = t >> kEtiDecayShift;                 // epochs before this write
      const int after = wrap_add(t, 1) >> kEtiDecayShift;     // after its decay tick
      const int c_new = eti_fold(tb.eti_count[e], tb.eti_last[e], before) + 1;
      // every extent's counter folded to `after`, this write's in it; the
      // mean an integer sum converted once to float32
      long long sum = 0;
      int mine = 0;
      for (int j = lane; j < tb.n_ext; j += 32) {
        const int temp = j == e ? eti_fold(c_new, before, after)
                                : eti_fold(tb.eti_count[j], tb.eti_last[j], after);
        sum += temp;
        mine = j == e ? temp : mine;
      }
      sum = warp_sum(sum);
      mine = __shfl_sync(kAll, mine, e % 32);
      const float mean = __fdiv_rn(__ll2float_rn(sum), __int2float_rn(tb.n_ext));
      const bool hot = __int2float_rn(mine) > fmaxf(mean, 1.0f);
      __syncwarp();
      if (lane == 0) {
        tb.eti_count[e] = c_new;
        tb.eti_last[e] = before;
      }
      cls = hot ? 0 : 1;
      break;
    }
    case kMq: {
      const int f = tb.mq_freq[lba] + 1;
      const int level_prev = tb.mq_level[lba], expire_prev = tb.mq_expire[lba];
      const int demote = (t > expire_prev && level_prev > 0) ? 1 : 0;
      const int ladder = (f >= 2) + (f >= 4) + (f >= 8) + (f >= 16);
      const int lvl = max(ladder, level_prev - demote);
      __syncwarp();
      if (lane == 0) {
        tb.mq_freq[lba] = f;
        tb.mq_level[lba] = lvl;
        tb.mq_expire[lba] = wrap_add(t, 4 * tb.seg_size);
      }
      cls = clampi(4 - lvl, 0, 5);
      break;
    }
    case kSfr: {
      const int ch = lba / kChunk;
      const float seq_f = lba == wrap_add(sc.sfr_prev, 1) ? 1.0f : 0.0f;
      const int dt = max(wrap_diff(t, tb.sfr_last[ch]), 0);
      const float freq = __fadd_rn(__fmul_rn(0.9f, tb.sfr_freq[ch]), 1.0f);
      __syncwarp();
      if (lane == 0) {
        tb.sfr_freq[ch] = freq;
        tb.sfr_last[ch] = t;
        sc.sfr_prev = lba;
      }
      // 0.4 * min(freq / 16, 1) + 0.4 / (1 + ln 2 * log2(dt + 1)) + 0.2 * (1 - seq)
      const float ln = __fmul_rn(0.6931471805599453f, log2_interp(wrap_add(dt, 1)));
      const float rec = __fdiv_rn(1.0f, __fadd_rn(1.0f, ln));
      const float fnorm = fminf(__fdiv_rn(freq, 16.0f), 1.0f);
      const float score = __fadd_rn(__fadd_rn(__fmul_rn(0.4f, fnorm), __fmul_rn(0.4f, rec)),
                                    __fmul_rn(0.2f, __fsub_rn(1.0f, seq_f)));
      const int lvl = __float2int_rz(fminf(fmaxf(__fmul_rn(score, 5.0f), 0.0f), 4.0f));
      cls = clampi(4 - lvl, 0, 5);
      break;
    }
    case kFadac: {
      const int ch = lba / kChunk;
      const int cnt = fadac_fold(tb.fadac_count[ch], tb.fadac_last[ch], t) + 1;
      __syncwarp();
      if (lane == 0) {
        tb.fadac_count[ch] = cnt;
        tb.fadac_last[ch] = t;
      }
      cls = fadac_class(cnt);
      break;
    }
    case kWarcip: {
      const int last = tb.warcip_last[lba];
      const bool known = last >= 0;
      const float li = warcip_interval(wrap_diff(t, last));
      // the nearest centroid, the first on a tie
      int j = 0;
      float best = fabsf(__fsub_rn(sc.warcip_cent[0], li));
#pragma unroll
      for (int k = 1; k < kCentroids; ++k) {
        const float d = fabsf(__fsub_rn(sc.warcip_cent[k], li));
        if (d < best) {
          best = d;
          j = k;
        }
      }
      // the online k-means step; the count increments before the capped divisor
      const float c2 = __fadd_rn(sc.warcip_cnt[j], 1.0f);
      const float cent = __fadd_rn(sc.warcip_cent[j],
                                   __fdiv_rn(__fsub_rn(li, sc.warcip_cent[j]), fminf(c2, 1024.0f)));
      __syncwarp();
      if (lane == 0) {
        if (known) {
          sc.warcip_cent[j] = cent;
          sc.warcip_cnt[j] = c2;
        }
        tb.warcip_last[lba] = t;
      }
      cls = known ? j : 4;
      break;
    }
    default:
      break;
  }
  __syncwarp();
  return cls;
}

// Ask L2 for the lines a user write of `lba` under a stateful `scheme` will
// read (a hint: the write still loads every value in order).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void prefetch_user(int scheme, const Tables& tb, int lba) {
  switch (scheme) {
    case kDac:
      prefetch_l2(tb.dac_region + lba);
      break;
    case kMl:
      prefetch_l2(tb.ml_count + lba);
      break;
    case kSfs:
      prefetch_l2(tb.sfs_first + lba);
      prefetch_l2(tb.sfs_count + lba);
      break;
    case kMq:
      prefetch_l2(tb.mq_freq + lba);
      prefetch_l2(tb.mq_level + lba);
      prefetch_l2(tb.mq_expire + lba);
      break;
    case kSfr:
      prefetch_l2(tb.sfr_freq + lba / kChunk);
      prefetch_l2(tb.sfr_last + lba / kChunk);
      break;
    case kFadac:
      prefetch_l2(tb.fadac_count + lba / kChunk);
      prefetch_l2(tb.fadac_last + lba / kChunk);
      break;
    case kWarcip:
      prefetch_l2(tb.warcip_last + lba);
      break;
    default:          // fk only writes its entry; eti's extents stay cached
      break;
  }
}

// -- GC rewrites (stateful.gc_classes) ----------------------------------------------

// The GC class of a live victim slot holding `lba`, at time `t`, under a
// stateful `scheme`; reads only (dac's and ml's updates are `gc_update`).
__device__ __forceinline__ int gc_class(int scheme, const Tables& tb, const Scalars& sc, int lba,
                                        int t) {
  switch (scheme) {
    case kFk:
      return fk_class(tb.fk_bit[lba], t, tb.seg_size);
    case kDac:
      return kClasses - 1 - clampi(tb.dac_region[lba] - 1, 0, kClasses - 1);
    case kMl:
      return kClasses - 1 - clampi(tb.ml_level[lba] - 1, 0, kClasses - 1);
    case kSfs:
      return sfs_class(sc, sfs_hotness(tb.sfs_count[lba], tb.sfs_first[lba], t));
    case kFadac:
      return fadac_class(fadac_fold(tb.fadac_count[lba / kChunk], tb.fadac_last[lba / kChunk], t));
    case kEti:
      return 2;
    default:          // mq, sfr, warcip
      return 5;
  }
}

// dac's and ml's GC updates, after every slot's class was read from the
// tables: a live slot's entry becomes 5 - its class (the region, or the
// level, it was classed by). The live slots' LBAs are distinct; where the
// exhausted pool duplicated one, both copies read the same entry and write
// the same value. Every lane calls it; `cls` is -1 for a dead slot.
__device__ __forceinline__ void gc_update(int scheme, const Tables& tb, const int* lbas,
                                          const int* cls, int s, int lane) {
  int* table = scheme == kDac ? tb.dac_region : scheme == kMl ? tb.ml_level : nullptr;
  if (table == nullptr) return;
  for (int j = lane; j < s; j += 32) {
    if (cls[j] >= 0) table[lbas[j]] = kClasses - 1 - cls[j];
  }
}

}  // namespace stateful_ops
