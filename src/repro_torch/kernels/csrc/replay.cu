// The whole fleet replay in one launch: per volume, every user write of its
// trace and, after each, its GC loop, with victim selection and GC
// classification done inside.
//
// Replaces, on the card, the step engine of core/torchsim.py (`_user_write`
// and `fleet_gc_tick` -> `_gc_once`: about 230 PyTorch launches and 1.66
// host syncs per lockstep step) together with the two TPU kernels on its
// path: segment_select_batch / segment_select (src/repro/kernels/segsel.py,
// the victim argmax; at V = 1 this kernel is the single-volume path) and
// classify (src/repro/kernels/classify.py, the GC classes; and the user
// write's class). Their per-element arithmetic is engine_ops.cuh, shared
// with segsel.cu and classify.cu.
//
// Why one kernel can do it: volumes are independent (the JAX package proves
// it with its provenance lints SA501-SA504), and each volume's GC iterations
// in the fleet's tick loop are a prefix of that loop (jaxsim.fleet_gc_tick),
// so a volume can run its own loop with no knowledge of the others. Each
// warp replays one volume from its first step to its last; no host
// decision is left.
//
// What it computes: exactly the step engine's transitions, in its order,
// so the final state is bit-equal to it (and to the JAX package):
//   user write: invalidate the predecessor (a slot offset >= s is dropped),
//     v = t - last_uw (int32, wraps), class, append to the class's open
//     segment (an offset >= s, only on the pad row, is dropped), cap the pad
//     row's fill at s, update loc_* and last_uw, seal when full and promote
//     the first free row (the pad row when none is free), the lat_dens EWMA
//     as a multiply then an add, the counters; a pad step (-1) is skipped;
//   GC loop: while gp > p_gp and fewer than max_gc_per_step iterations ran
//     this step, one GC operation: the victim argmax (none: the volume
//     stalls for the step), then the rewrite of `_gc_once`: ℓ bookkeeping,
//     the victim slots' classes, per-class ranks in slot order, the first C
//     free rows (class c takes the c-th whether it needs one or not),
//     destinations, per-class metadata, the victim's release, the counters;
//     in the kPaper instance (below), up to gc_batch victims an operation.
// Where several writes of one scatter of the step engine hit one element
// (only when the free pool is exhausted and classes alias the pad row), the
// last in slot or class order wins, as in the step engine on the CPU.
//
// What bounds it on this card: not the bytes the replay must move (the
// trace, and the state read and written once), but each volume's chain of
// dependent steps: a user write reads its LBA's location (a random line of
// tables far larger than L2), then its class's open segment; a GC iteration
// scores the volume's rows, reads the victim's slots, scans for free rows
// and moves the live slots. With a few warps an SM the time is that chain's
// latency; with tens of warps an SM the SM's issue slots run out, so a
// fleet takes about as long in one wave of resident warps as in two
// (`chip_smoke.py --replay-times`, PERF.md). Each GC iteration scores every
// eligible row, so the victim scan's cost per user write grows with the
// volume's row count and, at large volumes, outweighs the user writes
// ([scale]).
//
// Design: fewer instructions and fewer memory round trips per step.
//   Warps: a block holds `warps` volumes (kernels/replay.py `geometry`: up
//     to kMaxWarps, fewer for a fleet smaller than the card's SM count),
//     one warp each, v = blockIdx.x * warps + warp; warps past the fleet
//     return at once. No block-wide barrier: every sync is the warp's.
//   Registers: the per-volume scalars each step's chain reads stay in
//     registers, equal in every lane (lane c holds class c's open segment
//     and counters); those no step waits on, a stateful scheme's and the
//     timing model's, live once per warp in shared memory (`Vars`). Row
//     pointers are made from the arguments at use, and the warp's shared
//     layout is a constant argument. __launch_bounds__ caps the registers
//     of the instances a large fleet takes (MinBlocks).
//   Shared memory, per warp: `Vars`, the free rows, the victim's slots (read
//     whole before any move, as the step engine gathers them) and, where
//     the volume's rows fit (kSharedMeta), the
//     segment metadata: fill and valid counts as 16-bit halves of one word,
//     seal time, state and class byte, loaded once and written back once,
//     so scoring, the free-row scan, the fill reads, the seal and the pad
//     cap touch no global memory. The pad row's counts are 32-bit: only its
//     valid count can outgrow s (each user write that lands there adds one),
//     every other row's counts stay in [0, s]. ctime, the slots and the LBA
//     maps stay in global memory; where the rows do not fit, the metadata
//     does too.
//   Victim scan: only eligible rows (sealed, with garbage) are scored,
//     under the volume's own selector (every other row scores -inf, so the
//     argmax is the full scan's): each lane its own rows, or, in the
//     stateful instance, each chunk of kScanChunk rows compacted first to
//     its eligible rows by one ballot per 32 (each is faster where it is
//     used, PERF.md). The rewrite skips each round of 32 victim slots that
//     holds no live one (a victim holds few).
//   Prefetch: each 32-step chunk of the trace is read by the warp at once,
//     and lane k asks L2 for the lines its step's user write will read
//     (loc_seg, loc_off, last_uw and the scheme's own table entries).
// Ranks come from one ballot per class; duplicate targets are resolved with
// __match_any_sync so the highest slot (or class) writes. Counts that
// several lanes may add to (the pad row) use atomicAdd. The per-step GC
// iteration count goes to a (T,) buffer with atomicMax, so the host learns
// the tick counts with one read after the launch.
//
// The timing model and the GC schedules (jaxsim's cfg.timing and p_gcsched;
// torchsim._user_latency, _gc_deferred, _charge_gc) come in two template
// flags, so that the instance with both off runs none of it:
//   kTiming: per user write, the latency (closed loop: wait for the charged
//     GC work, then write_cost) into lat_now, lat_sum, lat_max and the
//     histogram, whose bucket is floor(4 * logf(x) / ln 2) as the plain
//     version computes it; per rewrite, k_total * gc_block_cost added to the
//     debt; after each real step's GC loop, the charge (all of the debt, or
//     at most charge_cap for rate_limited volumes);
//   kDefer (some volume runs idle_window): for idle_window volumes, the
//     defer predicate (write density above idle_density and free rows at or
//     above the watermark) joins the GC loop's guard. The free rows are a
//     per-warp count, made once at the start and kept as rows are promoted
//     and released, not a scan per GC iteration.
//   kStateful (some volume runs one of the nine stateful schemes: fk, dac,
//     ml, sfs, eti, mq, sfr, fadac, warcip; stateful_ops.cuh): such a
//     volume's user write takes its class from its scheme, which reads and
//     updates the written LBA's sch_* entries (fk also reads its (V, T)
//     next-write stream); its GC classes come from the scheme too, every
//     slot's class read into shared memory before dac and ml update their
//     tables. The per-volume scalars (sfs's counter, flag and bounds, sfr's
//     previous LBA, warcip's centroids) live in the warp's `Vars`. sfs refreshes its
//     bounds from exact order statistics of the hotness of the volume's
//     seen LBAs, written once per refresh into a scratch with one (n_lbas,)
//     row per sfs volume (its slot: the sfs volumes before it). The
//     elementwise volumes of such a fleet run the code above.
//   kSharedMeta: the segment metadata in shared memory (above).
//   kPaper (the numpy loop's knobs that the JAX engine lacks; greedy GC and
//     the timing model off, as the config requires):
//     GC operations of gc_batch = k > 1 victims (cfg.gc_batch_segments, the
//     paper's Exp#2): the GP is checked once an operation, which then takes
//     up to k victims, each the argmax of the rows sealed at its start (a
//     row a round seals is marked kSealedInOp, so no later round of the
//     operation takes it, and sealed when the operation ends), until a
//     round finds none; max_gc counts operations;
//     FIFO samples (cfg.fifo_occupancy, the paper's Exp#5): at each ℓ
//     refresh of a sepbit or uw volume, the LBAs whose last user write is
//     at or after t - trunc(min(ℓ, t)), into fifo_last and the running
//     maximum fifo_peak. The refresh only notes its window in a scratch;
//     the warp counts after the step's GC loop (t and last_uw do not move
//     inside it).
//     Its own instances, because in the others the same code, dead at
//     k = 1 without samples, cost 4-21 % (PERF.md).
// Every float op is a round-to-nearest intrinsic and the build has no fused
// multiply-add, so the lat_* and sch_* keys equal the plain version's bit for bit
// (logf can differ from the CPU's log by an ulp: only a latency within an
// ulp of a bucket edge would see it).
// The instances of the template are named by those five flags.

#include <cuda_runtime.h>

#include <climits>

#include "engine_ops.cuh"
#include "stateful_ops.cuh"

// The replay's arguments, passed by value to the kernel. Must match
// ReplayArgs in kernels/replay.py field for field. Outside the unnamed
// namespace, so that the C entry points that take it keep external linkage.
struct ReplayArgs {
  int* seg_lba;
  int* seg_utime;
  unsigned char* seg_valid;
  int* seg_n;
  int* seg_nvalid;
  int* seg_cls;
  int* seg_state;
  int* seg_ctime;
  int* seg_stime;
  int* open_sid;
  int* loc_seg;
  int* loc_off;
  int* last_uw;
  int* t;
  int* total_occ;
  int* total_valid;
  int* user_writes;
  int* gc_writes;
  int* reclaimed;
  int* overflow;
  float* ell;
  float* ell_tot;
  int* nc;
  int* class_user;
  int* class_gc;
  float* lat_dens;
  float* lat_now;
  float* lat_busy;
  float* lat_debt;
  float* lat_charged;
  float* lat_sum;
  float* lat_max;
  int* lat_hist;        // (V, lat_buckets)
  // the stateful schemes' tables, in stateful.state_spec's order
  int* sch_fk_bit;
  int* sch_dac_region;
  int* sch_ml_count;
  int* sch_ml_level;
  int* sch_sfs_count;
  int* sch_sfs_first;
  int* sch_sfs_since;
  float* sch_sfs_bounds;
  unsigned char* sch_sfs_ready;
  int* sch_eti_count;
  int* sch_eti_last;
  int* sch_mq_freq;
  int* sch_mq_level;
  int* sch_mq_expire;
  float* sch_sfr_freq;
  int* sch_sfr_last;
  int* sch_sfr_prev;
  int* sch_fadac_count;
  int* sch_fadac_last;
  int* sch_warcip_last;
  float* sch_warcip_cent;
  float* sch_warcip_cnt;
  const int* p_scheme;
  const int* p_selector;
  const float* p_gp;
  const int* p_ncw;
  const int* p_classes;
  const int* p_gcsched;
  const int* trace;     // (V, T), -1 = pad step
  int* iterations;      // (T,), zeroed by the caller
  const int* nxt;       // (V, T) fk's next-write indices; null when no volume runs fk
  unsigned* sfs_keys;   // (n_sfs, n_lbas) scratch of sfs's quantile refresh; null without sfs
  int* fifo_peak;       // (V,) SepBIT's FIFO-occupancy samples; null without cfg.fifo_occupancy
  int* fifo_last;
  int* fifo_window;     // (V, 2) scratch, -1 filled: a step's widest and newest FIFO window
  int n_volumes;
  int n_steps;
  int n_rows;
  int seg_size;
  int n_classes;        // class slots C
  int n_lbas;
  int max_gc;
  float dens_keep;      // 1 - 1/density_window, float32
  float dens_add;       // 1/density_window, float32
  int timing;           // cfg.timing: the kTiming instance
  int defer;            // some volume runs idle_window: the kDefer instance
  float write_cost;     // the timing model's float32 constants
  float gc_block_cost;
  float charge_cap;     // float32(gc_rate * gc_block_cost)
  float idle_density;
  float ln2;            // float32(log 2)
  int watermark_rows;
  int lat_buckets;
  int stateful;         // some volume runs a stateful scheme: the kStateful instance
  int sfs_resample;
  int warps;            // volumes (warps) per block, 1..kMaxWarps (kernels/replay.py geometry)
  int shared_meta;      // the segment metadata in shared memory: the kSharedMeta instance
  int smem_per_warp;    // shared memory bytes per warp; must equal warp_layout's total
  int gc_batch;         // victims per GC operation (cfg.gc_batch_segments), >= 1
  int fifo;             // cfg.fifo_occupancy; with gc_batch > 1, the kPaper instance
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 32;    // one lane per class slot
constexpr int kMaxSegSize = 4096;  // the victim's slots in shared memory
constexpr int kMaxWarps = 4;       // volumes (warps) per block
constexpr int kScanRows = 4;       // rows each lane loads per round of a free-row scan
constexpr int kScanChunk = 256;    // rows a compacted victim scan gathers at a time
constexpr int kRateLimited = 1;    // config.GCSCHED_IDS
constexpr int kIdleWindow = 2;
constexpr int kSepbit = 2, kUw = 7;   // the schemes whose ℓ refreshes take a FIFO sample
constexpr int kSealedInOp = 4;     // a row sealed inside a GC operation of k > 1 victims

// Blocks of kMaxWarps warps an instance is compiled to keep resident on one
// SM (__launch_bounds__ derives its register cap from it). The elementwise
// and timing instances: 6, so 80 registers, and [sweep]'s 5,580 volumes
// take two waves of 3,168, not three. The stateful instance: 1, no cap
// below what it needs; a cap of 128 registers spilled, and the spills cost
// more on every fleet than the resident volumes they bought (PERF.md).
// Tighter caps (11 blocks at 40 registers, 5 at 96) would hold [sweep]'s
// and [schemes]' 2,604 volumes in one wave, but their spills made every
// step slower than the second wave costs: past a few warps an SM the
// replay is bound by the SM's issue slots, not by the volumes in flight.
template <bool kStateful>
struct MinBlocks {
  static constexpr int value = kStateful ? 1 : 6;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The per-volume scalars no step's chain of dependent operations waits on
// live once per warp in shared memory: a stateful scheme's and the timing
// model's (every lane reads them, lane 0 writes them between two
// __syncwarp), so they hold no register across the GC loop. Every other
// per-volume scalar stays in registers, equal in every lane.
struct Timing {
  float now, busy, debt, charged, sum, max;
};

struct Vars {
  stateful_ops::Scalars sc;
  Timing tm;
};
static_assert(align16(static_cast<int>(sizeof(Vars))) == 96, "kernels/replay.py VARS_BYTES");

// Byte offsets of one warp's shared memory; kernels/replay.py `warp_bytes`
// computes the same total.
struct WarpLayout {
  int free_rows, lba, utime, cls, valid, scan;
  int counts, stime, state, seg_cls, pad, total;
};

__host__ __device__ inline WarpLayout warp_layout(int s, int R, int C, bool stateful,
                                                  bool shared_meta) {
  WarpLayout L{};
  int at = align16(static_cast<int>(sizeof(Vars)));
  L.free_rows = at;
  at += align16(4 * C);
  L.lba = at;
  at += align16(4 * s);
  L.utime = at;
  at += align16(4 * s);
  L.cls = at;                       // kStateful: the victim slots' classes
  at += stateful ? align16(4 * s) : 0;
  L.valid = at;
  at += align16(s);
  L.scan = at;                      // kStateful: a compacted victim scan's rows
  at += stateful ? kScanChunk : 0;
  L.counts = at;                    // kSharedMeta: the segment metadata
  at += shared_meta ? align16(4 * R) : 0;
  L.stime = at;
  at += shared_meta ? align16(4 * R) : 0;
  L.state = at;
  at += shared_meta ? align16(R) : 0;
  L.seg_cls = at;
  at += shared_meta ? align16(R) : 0;
  L.pad = at;
  at += shared_meta ? 16 : 0;
  L.total = at;
  return L;
}

// int32 subtraction and addition that wrap like the reference's
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// True in the highest lane among those whose `key` matches this lane's.
// Every lane of the warp must call it.
template <typename K>
__device__ __forceinline__ bool highest_of_group(K key, int lane) {
  return ((__match_any_sync(kFull, key) >> lane) >> 1) == 0;
}

// One volume's segment metadata in global memory, one int32 array a field.
struct GlobalMeta {
  const ReplayArgs& a;
  long long row0;
  int pad;

  __device__ int n(int r) const { return a.seg_n[row0 + r]; }
  __device__ void counts(int r, int& n, int& nv) const {
    n = a.seg_n[row0 + r];
    nv = a.seg_nvalid[row0 + r];
  }
  __device__ int state(int r) const { return a.seg_state[row0 + r]; }
  __device__ int cls(int r) const { return a.seg_cls[row0 + r]; }
  __device__ int stime(int r) const { return a.seg_stime[row0 + r]; }
  __device__ void set_n(int r, int x) const { a.seg_n[row0 + r] = x; }
  __device__ void add_nvalid(int r, int d) const { atomicAdd(&a.seg_nvalid[row0 + r], d); }
  __device__ void add_counts(int r, int d) const {
    atomicAdd(&a.seg_n[row0 + r], d);
    atomicAdd(&a.seg_nvalid[row0 + r], d);
  }
  __device__ void clear_counts(int r) const {
    a.seg_n[row0 + r] = 0;
    a.seg_nvalid[row0 + r] = 0;
  }
  __device__ void set_state(int r, int x) const { a.seg_state[row0 + r] = x; }
  __device__ void set_cls(int r, int x) const { a.seg_cls[row0 + r] = x; }
  __device__ void set_stime(int r, int x) const { a.seg_stime[row0 + r] = x; }
  __device__ void cap_pad(int s) const {
    if (a.seg_n[row0 + pad] > s) a.seg_n[row0 + pad] = s;
  }
  __device__ void load(int) const {}
  __device__ void store(int) const {}
};

// One volume's segment metadata in the warp's shared memory: a row's fill
// count in the low and its valid count (as int16) in the high half of one
// word, its seal time, its state and its class as a byte each. The pad
// row's counts are two int32 of their own: its valid count grows by one for
// each user write that lands there, while every other row's counts stay in
// [0, s] (kernels/replay.py checks they start there). Loaded from and
// stored to the global arrays once per replay.
struct SharedMeta {
  const ReplayArgs& a;
  long long row0;
  int pad;
  unsigned* cnt;
  int* stime_;
  unsigned char* state_;
  unsigned char* cls_;
  int* pad_cnt;     // the pad row's n and nvalid

  __device__ int n(int r) const {
    return r == pad ? pad_cnt[0] : static_cast<int>(cnt[r] & 0xffffu);
  }
  __device__ void counts(int r, int& n, int& nv) const {
    const unsigned w = cnt[r];
    n = r == pad ? pad_cnt[0] : static_cast<int>(w & 0xffffu);
    nv = r == pad ? pad_cnt[1] : static_cast<int>(w) >> 16;
  }
  __device__ int state(int r) const { return state_[r]; }
  __device__ int cls(int r) const { return cls_[r]; }
  __device__ int stime(int r) const { return stime_[r]; }
  __device__ void set_n(int r, int x) const {
    if (r == pad) {
      pad_cnt[0] = x;
    } else {
      cnt[r] = (cnt[r] & 0xffff0000u) | static_cast<unsigned>(x);
    }
  }
  __device__ void add_nvalid(int r, int d) const {
    if (r == pad) {
      atomicAdd(&pad_cnt[1], d);
    } else {
      atomicAdd(&cnt[r], static_cast<unsigned>(d) << 16);
    }
  }
  __device__ void add_counts(int r, int d) const {   // 0 < d <= s: no carry into the high half
    if (r == pad) {
      atomicAdd(&pad_cnt[0], d);
      atomicAdd(&pad_cnt[1], d);
    } else {
      atomicAdd(&cnt[r], static_cast<unsigned>(d) * 0x10001u);
    }
  }
  __device__ void clear_counts(int r) const {
    if (r == pad) {
      pad_cnt[0] = 0;
      pad_cnt[1] = 0;
    } else {
      cnt[r] = 0u;
    }
  }
  __device__ void set_state(int r, int x) const { state_[r] = static_cast<unsigned char>(x); }
  __device__ void set_cls(int r, int x) const { cls_[r] = static_cast<unsigned char>(x); }
  __device__ void set_stime(int r, int x) const { stime_[r] = x; }
  __device__ void cap_pad(int s) const {
    if (pad_cnt[0] > s) pad_cnt[0] = s;
  }
  __device__ void load(int lane) const {
    for (int r = lane; r <= pad; r += 32) {
      const int n = a.seg_n[row0 + r], nv = a.seg_nvalid[row0 + r];
      if (r == pad) {
        pad_cnt[0] = n;
        pad_cnt[1] = nv;
      }
      cnt[r] = (static_cast<unsigned>(n) & 0xffffu) | (static_cast<unsigned>(nv) << 16);
      stime_[r] = a.seg_stime[row0 + r];
      state_[r] = static_cast<unsigned char>(a.seg_state[row0 + r]);
      cls_[r] = static_cast<unsigned char>(a.seg_cls[row0 + r]);
    }
  }
  __device__ void store(int lane) const {
    for (int r = lane; r <= pad; r += 32) {
      int n, nv;
      counts(r, n, nv);
      a.seg_n[row0 + r] = n;
      a.seg_nvalid[row0 + r] = nv;
      a.seg_stime[row0 + r] = stime_[r];
      a.seg_state[row0 + r] = state_[r];
      a.seg_cls[row0 + r] = cls_[r];
    }
  }
};

template <bool kShared>
__device__ __forceinline__ auto make_meta(const ReplayArgs& a, unsigned char* base,
                                          const WarpLayout& L, long long row0, int pad) {
  if constexpr (kShared) {
    return SharedMeta{a, row0, pad, reinterpret_cast<unsigned*>(base + L.counts),
                      reinterpret_cast<int*>(base + L.stime), base + L.state, base + L.seg_cls,
                      reinterpret_cast<int*>(base + L.pad)};
  } else {
    return GlobalMeta{a, row0, pad};
  }
}

// The first `want` rows with state 0 (free), ascending, into out[0, want);
// the pad row past the end of the free pool. Every lane must call it.
template <class Meta>
__device__ __forceinline__ void first_free_rows(const Meta& meta, int n_rows, int pad, int want,
                                                int* out, int lane) {
  int found = 0;
  for (int base = 0; base < n_rows && found < want; base += 32 * kScanRows) {
    int st[kScanRows];
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const int r = base + k * 32 + lane;
      st[k] = r < n_rows ? meta.state(r) : -1;
    }
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const unsigned m = __ballot_sync(kFull, st[k] == 0);
      const int pos = found + __popc(m & lanes_below(lane));
      if (st[k] == 0 && pos < want) out[pos] = base + k * 32 + lane;
      found += __popc(m);
    }
  }
  for (int c = found + lane; c < want; c += 32) out[c] = pad;
  __syncwarp();
}

// Scores the rows `list` names (offsets from `chunk`, ascending) with
// `score` into each lane's running maximum; a lane's rows rise, so its
// first maximum stays.
template <class Score>
__device__ __forceinline__ void score_rows(const unsigned char* list, int found, int chunk,
                                           Score score, float& best, int& best_i, int lane) {
  for (int i = lane; i < found; i += 32) {
    const int j = chunk + list[i];
    const float s = score(j);
    if (s > best) {
      best = s;
      best_i = j;
    }
  }
}

// The warp's argmax of each lane's (best, best_i): every lane gets the
// victim, -1 when no row is eligible.
__device__ __forceinline__ int warp_victim(float best, int best_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_xor_sync(kFull, best, off);
    const int i = __shfl_xor_sync(kFull, best_i, off);
    if (engine_ops::beats(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }
  return best == -INFINITY ? -1 : best_i;
}

// The victim argmax of segsel.cu over one volume's rows, reduced across the
// warp. Only sealed rows with garbage can win (every other row scores
// -inf), so only those are scored, under the volume's own selector: the
// result is the full scan's, with a fraction of its divisions. Each lane
// scores its own eligible rows (kCompact false), or each chunk of
// kScanChunk rows is first compacted to its eligible rows in `list` (the
// warp's scratch) and the lanes score those (kCompact: faster in the
// stateful instance, slower in the others, PERF.md).
template <bool kCompact, class Meta>
__device__ __forceinline__ int select_victim(const Meta& meta, int n_rows, int t, int selector,
                                             unsigned char* list, int lane) {
  float best = -INFINITY;
  int best_i = INT_MAX;
  if constexpr (!kCompact) {
#pragma unroll 4
    for (int j = lane; j < n_rows; j += 32) {
      int n, nv;
      meta.counts(j, n, nv);
      if (!engine_ops::eligible(n, nv, meta.state(j))) continue;
      const float s = selector == 0 ? engine_ops::greedy_score(n, nv)
                                    : engine_ops::cost_benefit_score(n, nv, meta.stime(j), t);
      if (s > best) {  // j rises along the loop, so the first maximum stays
        best = s;
        best_i = j;
      }
    }
    return warp_victim(best, best_i);
  }
  for (int chunk = 0; chunk < n_rows; chunk += kScanChunk) {
    const int end = min(chunk + kScanChunk, n_rows);
    int found = 0;
#pragma unroll
    for (int base = chunk; base < chunk + kScanChunk; base += 32) {
      const int j = base + lane;
      bool ok = false;
      if (j < end) {
        int n, nv;
        meta.counts(j, n, nv);
        ok = engine_ops::eligible(n, nv, meta.state(j));
      }
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) list[found + __popc(m & lanes_below(lane))] = static_cast<unsigned char>(j - chunk);
      found += __popc(m);
    }
    __syncwarp();
    if (selector == 0) {
      score_rows(list, found, chunk, [&](int j) {
        int n, nv;
        meta.counts(j, n, nv);
        return engine_ops::greedy_score(n, nv);
      }, best, best_i, lane);
    } else {
      score_rows(list, found, chunk, [&](int j) {
        int n, nv;
        meta.counts(j, n, nv);
        return engine_ops::cost_benefit_score(n, nv, meta.stime(j), t);
      }, best, best_i, lane);
    }
    __syncwarp();     // every lane's reads of the list before the next chunk's
  }
  return warp_victim(best, best_i);
}

// The end of a GC operation of gc_batch > 1 victims: the rows its rounds
// sealed (marked kSealedInOp, so no later round took them) are sealed rows.
template <class Meta>
__device__ __forceinline__ void end_operation(const Meta& meta, int n_rows, int gc_batch,
                                              int lane) {
  if (gc_batch == 1) return;
  __syncwarp();
  for (int j = lane; j < n_rows; j += 32) {
    if (meta.state(j) == kSealedInOp) meta.set_state(j, 2);
  }
  __syncwarp();
}

// Rows with state 0 (free) of one volume, summed across the warp.
template <class Meta>
__device__ __forceinline__ int count_free_rows(const Meta& meta, int n_rows, int lane) {
  int count = 0;
  for (int j = lane; j < n_rows; j += 32) count += meta.state(j) == 0 ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  return count;
}

// SepBIT's FIFO window at an ℓ refresh (torchsim._sample_fifo):
// trunc(min(ell, t)) writes.
__device__ __forceinline__ int fifo_width(float ell, int t) {
  return static_cast<double>(ell) >= static_cast<double>(t) ? t : __float2int_rz(ell);
}

// SepBIT's FIFO-occupancy sample: the LBAs of one volume whose last user
// write is at or after t - w, summed across the warp.
__device__ __forceinline__ int fifo_count(const int* last_uw, int n_lbas, int t, int w,
                                          int lane) {
  const int from = wrap_sub(t, w);
  int count = 0;
  for (int j = lane; j < n_lbas; j += 32) count += last_uw[j] >= from ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  return count;
}

// Volumes before v that run sfs, summed across the warp: v's row of the
// refresh scratch, which holds one row per sfs volume.
__device__ __forceinline__ int sfs_slot(const int* p_scheme, int v, int lane) {
  int count = 0;
  for (int j = lane; j < v; j += 32) count += p_scheme[j] == stateful_ops::kSfs ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  return count;
}

// One volume's rows of the stateful schemes' tables, made where they are
// used (no pointer stays live across the replay); `slot` is its row of sfs's
// refresh scratch.
__device__ __forceinline__ stateful_ops::Tables volume_tables(const ReplayArgs& a, int v,
                                                              int slot) {
  const long long n = a.n_lbas;
  const long long n_ext = (n + stateful_ops::kEtiExtent - 1) / stateful_ops::kEtiExtent;
  const long long n_ch = (n + stateful_ops::kChunk - 1) / stateful_ops::kChunk;
  return {a.sch_fk_bit + v * n, a.sch_dac_region + v * n, a.sch_ml_count + v * n,
          a.sch_ml_level + v * n, a.sch_sfs_count + v * n, a.sch_sfs_first + v * n,
          a.sfs_keys == nullptr ? nullptr : a.sfs_keys + slot * n,
          a.sch_eti_count + v * n_ext, a.sch_eti_last + v * n_ext,
          a.sch_mq_freq + v * n, a.sch_mq_level + v * n, a.sch_mq_expire + v * n,
          a.sch_sfr_freq + v * n_ch, a.sch_sfr_last + v * n_ch,
          a.sch_fadac_count + v * n_ch, a.sch_fadac_last + v * n_ch,
          a.sch_warcip_last + v * n, a.n_lbas, static_cast<int>(n_ext), a.seg_size,
          a.sfs_resample};
}

template <bool kTiming, bool kDefer, bool kStateful, bool kSharedMeta, bool kPaper>
__global__ void __launch_bounds__(32 * kMaxWarps, MinBlocks<kStateful>::value)
    replay_kernel(const __grid_constant__ ReplayArgs a, const __grid_constant__ WarpLayout L) {
  // both arguments are read in place (constant operands, never copied);
  // L is warp_layout(...) of this instance, made once on the host
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * a.warps + (threadIdx.x >> 5);
  if (v >= a.n_volumes) return;    // the last block's spare warps
  const int s = a.seg_size, R = a.n_rows, C = a.n_classes, pad = R - 1;
  unsigned char* const wbase = smem + (threadIdx.x >> 5) * L.total;
  Vars& vars = *reinterpret_cast<Vars*>(wbase);
  stateful_ops::Scalars& sc = vars.sc;
  Timing& tm = vars.tm;
  int* const sh_free = reinterpret_cast<int*>(wbase + L.free_rows);   // C
  int* const sh_lba = reinterpret_cast<int*>(wbase + L.lba);          // s
  int* const sh_utime = reinterpret_cast<int*>(wbase + L.utime);      // s
  int* const sh_cls = reinterpret_cast<int*>(wbase + L.cls);          // s, kStateful only
  unsigned char* const sh_valid = wbase + L.valid;                    // s
  const long long row0 = static_cast<long long>(v) * R;
  const long long lba0 = static_cast<long long>(v) * a.n_lbas;
  const auto meta = make_meta<kSharedMeta>(a, wbase, L, row0, pad);

  const int scheme = a.p_scheme[v];
  const bool stateful = kStateful && stateful_ops::is_stateful(scheme);
  const bool reads_next = stateful && scheme == stateful_ops::kFk;
  const bool deferring = kDefer && a.p_gcsched[v] == kIdleWindow;
  // the volume's scalars, in registers for the whole replay (the user write
  // count is not kept: it grows with t)
  int t = a.t[v], total_occ = a.total_occ[v], total_valid = a.total_valid[v];
  int gc_writes = a.gc_writes[v], reclaimed = a.reclaimed[v], overflow = a.overflow[v];
  int nc = a.nc[v];
  float ell = a.ell[v], ell_tot = a.ell_tot[v], lat_dens = a.lat_dens[v];
  const int selector = a.p_selector[v], ncw = a.p_ncw[v], live_classes = a.p_classes[v];
  const float gp_limit = a.p_gp[v];
  // the GC schedule, and the timing model's per-volume scalars
  const int sched = (kTiming || kDefer) ? a.p_gcsched[v] : 0;
  if (kTiming && lane == 0) {
    tm = {a.lat_now[v], a.lat_busy[v], a.lat_debt[v], a.lat_charged[v], a.lat_sum[v],
          a.lat_max[v]};
  }
  // lane c holds class slot c's open segment and counters
  const long long cls0 = static_cast<long long>(v) * C;
  const bool has_class = lane < C;
  int open_sid = has_class ? a.open_sid[cls0 + lane] : 0;
  int class_user = has_class ? a.class_user[cls0 + lane] : 0;
  int class_gc = has_class ? a.class_gc[cls0 + lane] : 0;
  meta.load(lane);
  // a stateful scheme's scalars, and an sfs volume's row of the refresh scratch
  const int slot = kStateful && scheme == stateful_ops::kSfs ? sfs_slot(a.p_scheme, v, lane) : 0;
  if (stateful && lane == 0) {
    stateful_ops::load_scalars(scheme, a.sch_sfs_since + v, a.sch_sfs_ready + v,
                               a.sch_sfs_bounds + v * stateful_ops::kBounds, a.sch_sfr_prev + v,
                               a.sch_warcip_cent + v * stateful_ops::kCentroids,
                               a.sch_warcip_cnt + v * stateful_ops::kCentroids, sc);
  }
  __syncwarp();   // the metadata and scalars in place before any lane reads them
  int free_rows = deferring ? count_free_rows(meta, R, lane) : 0;

  const long long trace0 = static_cast<long long>(v) * a.n_steps;
  for (int base = 0; base < a.n_steps; base += 32) {
    // the warp reads 32 steps at once; lane k asks L2 for the lines step
    // base + k's user write will read
    const int ahead = base + lane < a.n_steps ? a.trace[trace0 + base + lane] : -1;
    const int next_ahead = reads_next && base + lane < a.n_steps ? a.nxt[trace0 + base + lane] : 0;
    if (ahead >= 0) {
      stateful_ops::prefetch_l2(a.loc_seg + lba0 + ahead);
      stateful_ops::prefetch_l2(a.loc_off + lba0 + ahead);
      stateful_ops::prefetch_l2(a.last_uw + lba0 + ahead);
      if (stateful) stateful_ops::prefetch_user(scheme, volume_tables(a, v, 0), ahead);
    }
    const int n_here = min(32, a.n_steps - base);
    for (int k = 0; k < n_here; ++k) {
      const int lba = __shfl_sync(kFull, ahead, k);
      if (lba < 0) continue;    // a pad step of a shorter trace: no write, no GC
      __syncwarp();

      // ---- user write (torchsim._user_write) ----
      const int old_sid = a.loc_seg[lba0 + lba], old_off = a.loc_off[lba0 + lba];
      const int lifespan = wrap_sub(t, a.last_uw[lba0 + lba]);
      const bool had_old = old_sid >= 0;
      int cls;
      if (stateful) {   // the scheme's class, its tables updated (stateful.user_classes)
        const int next = reads_next ? __shfl_sync(kFull, next_ahead, k) : 0;
        cls = stateful_ops::user_class(scheme, volume_tables(a, v, slot), sc, lba, t, next,
                                       lane);
      } else {
        cls = engine_ops::classify_one(scheme, ell, lifespan, 0, false, false);
      }
      const int sid = __shfl_sync(kFull, open_sid, cls);
      const int off = meta.n(sid);
      const int n_new = sid == pad ? min(off + 1, s) : off + 1;
      __syncwarp();     // every lane's reads before lane 0 writes
      if (lane == 0) {
        if (had_old) {
          if (old_off < s) a.seg_valid[(row0 + old_sid) * s + old_off] = 0;
          meta.add_nvalid(old_sid, -1);
        }
        if (off < s) {
          const long long at = (row0 + sid) * s + off;
          a.seg_lba[at] = lba;
          a.seg_utime[at] = t;
          a.seg_valid[at] = 1;
        }
        meta.set_n(sid, n_new);
        meta.add_nvalid(sid, 1);
        a.loc_seg[lba0 + lba] = sid;
        a.loc_off[lba0 + lba] = off;
        a.last_uw[lba0 + lba] = t;
      }
      if (n_new >= s) {     // sealed: promote the first free row
        first_free_rows(meta, R, pad, 1, sh_free, lane);   // syncs the warp
        const int fresh = sh_free[0];
        if (lane == 0) {
          meta.set_state(sid, 2);
          meta.set_stime(sid, t);
          meta.set_state(fresh, 1);
          meta.set_cls(fresh, cls);
          a.seg_ctime[row0 + fresh] = t;
        }
        if (lane == cls) open_sid = fresh;
        overflow += fresh == pad ? 1 : 0;
        if (deferring) free_rows -= fresh == pad ? 0 : 1;
      }
      lat_dens = __fadd_rn(__fmul_rn(lat_dens, a.dens_keep), a.dens_add);
      if (kTiming) {   // torchsim._user_latency
        const float arrive = tm.now;
        const float latency = __fadd_rn(fmaxf(__fsub_rn(tm.busy, arrive), 0.0f), a.write_cost);
        // a write that waited for nothing has the ratio 1 and bucket 0
        // (logf(1) is exactly 0): most writes skip the logarithm
        float b = 0.0f;
        if (latency != a.write_cost) {
          const float log2 = __fdiv_rn(logf(__fdiv_rn(latency, a.write_cost)), a.ln2);
          b = fminf(fmaxf(floorf(__fmul_rn(4.0f, log2)), 0.0f), __int2float_rn(a.lat_buckets - 1));
        }
        const float sum = __fadd_rn(tm.sum, latency), most = fmaxf(tm.max, latency);
        __syncwarp();
        if (lane == 0) {
          tm.now = __fadd_rn(arrive, latency);
          tm.sum = sum;
          tm.max = most;
          atomicAdd(&a.lat_hist[static_cast<long long>(v) * a.lat_buckets + __float2int_rz(b)], 1);
        }
      }
      t += 1;
      total_occ += 1;
      total_valid += had_old ? 0 : 1;
      if (lane == cls) class_user += 1;
      __syncwarp();

      // ---- GC loop (torchsim.fleet_gc_tick, one volume) ----
      int iters = 0;
      int taken = 0;    // kPaper: victims of the GC operation in progress
      for (int it = 0; it < a.max_gc;) {
        if (!kPaper || taken == 0) {   // a GC operation starts: GP checked once
          const float occ = __int2float_rn(max(total_occ, 1));
          const float gp = __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(total_valid), occ));
          if (!(gp > gp_limit)) break;
          if (deferring && lat_dens > a.idle_density && free_rows >= a.watermark_rows) break;
          ++iters;
        }
        const int victim = select_victim<kStateful>(meta, R, t, selector, wbase + L.scan, lane);
        if (victim < 0) {
          if (!kPaper || taken == 0) break;   // stalled for the rest of this step
          end_operation(meta, R, a.gc_batch, lane);   // a round with none ends it
          taken = 0;
          ++it;
          continue;
        }
        // kPaper: a row this round seals waits for the operation's next round
        const bool mark = kPaper && taken + 1 < a.gc_batch;

        // ---- rewrite the victim (torchsim._gc_once) ----
        const long long vslot0 = (row0 + victim) * s;
        int victim_n, k_total;
        meta.counts(victim, victim_n, k_total);
        const int victim_cls = meta.cls(victim), victim_ctime = a.seg_ctime[row0 + victim];
        for (int j = lane; j < s; j += 32) {
          sh_lba[j] = a.seg_lba[vslot0 + j];
          sh_utime[j] = a.seg_utime[vslot0 + j];
          sh_valid[j] = a.seg_valid[vslot0 + j];
        }
        const int n0 = has_class ? meta.n(open_sid) : 0;
        // ℓ bookkeeping (Algorithm 1 lines 4-9)
        const bool is_c1 = victim_cls == 0;
        nc += is_c1 ? 1 : 0;
        const float life = __int2float_rn(wrap_sub(t, victim_ctime));
        ell_tot = __fadd_rn(ell_tot, is_c1 ? life : 0.0f);
        if (nc >= ncw) {
          ell = __fdiv_rn(ell_tot, __int2float_rn(max(nc, 1)));
          nc = 0;
          ell_tot = 0.0f;
          if (kPaper && a.fifo_window != nullptr && (scheme == kSepbit || scheme == kUw) &&
              !isinf(ell) && lane == 0) {   // a FIFO sample, counted after the step's GC loop
            const int w = fifo_width(ell, t);
            a.fifo_window[2 * v] = max(a.fifo_window[2 * v], w);
            a.fifo_window[2 * v + 1] = w;
          }
        }
        first_free_rows(meta, R, pad, C, sh_free, lane);   // syncs the warp
        const int free_row = has_class ? sh_free[lane] : pad;

        if (kStateful) {
          // every slot's class before any table changes (stateful.gc_classes
          // reads them all, then dac and ml write theirs): -1 for a dead slot
          for (int j = lane; j < s; j += 32) {
            const bool live = sh_valid[j] != 0;
            sh_cls[j] = !live     ? -1
                        : stateful ? stateful_ops::gc_class(scheme, volume_tables(a, v, slot), sc,
                                                            sh_lba[j], t)
                                   : engine_ops::classify_one(scheme, ell, 0,
                                                              wrap_sub(t, sh_utime[j]), is_c1,
                                                              true);
          }
          __syncwarp();
          if (stateful) {
            stateful_ops::gc_update(scheme, volume_tables(a, v, slot), sh_lba, sh_cls, s, lane);
          }
        }

        // classes, ranks and destinations of the victim's slots, 32 at a time
        const int room = max(s - n0, 0);
        int per_cls = 0;    // lane c: live slots of class c so far
        for (int b = 0; b < s; b += 32) {
          const int j = b + lane;
          const bool live = j < s && sh_valid[j] != 0;
          if (!__any_sync(kFull, live)) continue;   // a round with no live slot moves nothing
          const int blk = j < s ? sh_lba[j] : 0;
          const int ut = j < s ? sh_utime[j] : 0;
          const int c = !live     ? -1
                        : kStateful ? sh_cls[j]
                                    : engine_ops::classify_one(scheme, ell, 0, wrap_sub(t, ut),
                                                               is_c1, true);
          int rank = 0;
          for (int q = 0; q < C; ++q) {
            const unsigned m = __ballot_sync(kFull, c == q);
            const int before = __shfl_sync(kFull, per_cls, q);
            if (c == q) rank = before + __popc(m & lanes_below(lane));
            if (lane == q) per_cls += __popc(m);
          }
          const int src = live ? c : 0;
          const int room_c = __shfl_sync(kFull, room, src);
          const int n0_c = __shfl_sync(kFull, n0, src);
          const int open_c = __shfl_sync(kFull, open_sid, src);
          const int free_c = __shfl_sync(kFull, free_row, src);
          const bool first = rank < room_c;
          const int dst_sid = first ? open_c : free_c;
          const int dst_off = first ? n0_c + rank : rank - room_c;
          const bool put = live && dst_off < s;
          const long long at = put ? (row0 + dst_sid) * s + dst_off : -1 - lane;
          if (highest_of_group(at, lane) && put) {
            a.seg_lba[at] = blk;
            a.seg_utime[at] = ut;
            a.seg_valid[at] = 1;
          }
          if (highest_of_group(live ? blk : -1 - lane, lane) && live) {
            a.loc_seg[lba0 + blk] = dst_sid;
            a.loc_off[lba0 + blk] = dst_off;
          }
          __syncwarp();
        }

        // per-class metadata: fill counts, first-block time, seal-if-full,
        // promote-fresh; padded class slots (>= p_classes) count no blocks
        const int took1 = min(per_cls, room), took2 = per_cls - took1;
        const bool sealed = has_class && lane < live_classes && n0 + took1 >= s;
        if (has_class) {
          if (took1 > 0) meta.add_counts(open_sid, took1);
          if (took2 > 0) meta.add_counts(free_row, took2);
          if (n0 == 0 && per_cls > 0) a.seg_ctime[row0 + open_sid] = t;
          if (sealed) {
            meta.set_state(open_sid, mark ? kSealedInOp : 2);
            meta.set_stime(open_sid, t);
          }
        }
        __syncwarp();
        if (highest_of_group(sealed ? free_row : -1 - lane, lane) && sealed) {
          meta.set_state(free_row, 1);
          meta.set_cls(free_row, lane);
          a.seg_ctime[row0 + free_row] = t;
        }
        const bool pad_fill = has_class && ((open_sid == pad && took1 > 0) ||
                                            (free_row == pad && took2 > 0));
        overflow += __popc(
            __ballot_sync(kFull, has_class && free_row == pad && (took2 > 0 || sealed)));
        // the free rows promoted here (idle_window counts them)
        const int promoted =
            deferring ? __popc(__ballot_sync(kFull, sealed && free_row != pad)) : 0;
        if (sealed) open_sid = free_row;
        const bool cap_pad = __any_sync(kFull, pad_fill);
        __syncwarp();
        if (cap_pad && lane == 0) meta.cap_pad(s);
        __syncwarp();

        // release the victim (the pad row returns to reserved state 3; its
        // dead slots' flags are 0 already); the volume's counters
        if (lane == 0) {
          meta.set_state(victim, victim == pad ? 3 : 0);
          meta.clear_counts(victim);
        }
        for (int j = lane; j < s; j += 32) a.seg_valid[vslot0 + j] = 0;
        // the rewrite's device time, booked as debt
        const float booked = __fmul_rn(__int2float_rn(k_total), a.gc_block_cost);
        const float debt = kTiming ? __fadd_rn(tm.debt, booked) : 0.0f;
        __syncwarp();
        if (kTiming && lane == 0) tm.debt = debt;
        total_occ = total_occ - victim_n + k_total;
        if (deferring) free_rows += (victim == pad ? 0 : 1) - promoted;
        gc_writes += k_total;
        reclaimed += 1;
        class_gc += per_cls;
        if (!kPaper || ++taken == a.gc_batch) {   // the operation ends
          if (kPaper) end_operation(meta, R, a.gc_batch, lane);
          taken = 0;
          ++it;
        }
      }
      if (lane == 0 && iters > 0) atomicMax(&a.iterations[base + k], iters);
      if (kPaper && a.fifo_window != nullptr && (scheme == kSepbit || scheme == kUw)) {
        // the step's FIFO samples: t and last_uw stay as they are through
        // its GC loop, and the count grows with the window, so the samples
        // of its refreshes are the newest window's count and, for the
        // peak, the widest's
        __syncwarp();
        const int widest = a.fifo_window[2 * v], newest = a.fifo_window[2 * v + 1];
        if (widest >= 0) {
          const int last = fifo_count(a.last_uw + lba0, a.n_lbas, t, newest, lane);
          const int most =
              widest == newest ? last : fifo_count(a.last_uw + lba0, a.n_lbas, t, widest, lane);
          __syncwarp();
          if (lane == 0) {
            a.fifo_last[v] = last;
            a.fifo_peak[v] = max(a.fifo_peak[v], most);
            a.fifo_window[2 * v] = -1;
          }
        }
      }
      if (kTiming) {   // torchsim._charge_gc, after the step's GC loop
        __syncwarp();   // the loop's last debt stored
        const float debt = tm.debt;
        const float charge = sched == kRateLimited ? fminf(debt, a.charge_cap) : debt;
        const float busy = __fadd_rn(fmaxf(tm.busy, tm.now), charge);
        const float charged = __fadd_rn(tm.charged, charge);
        __syncwarp();
        if (lane == 0) {
          tm.busy = busy;
          tm.debt = __fsub_rn(debt, charge);
          tm.charged = charged;
        }
      }
    }
  }

  __syncwarp();
  meta.store(lane);
  if (has_class) {
    a.open_sid[cls0 + lane] = open_sid;
    a.class_user[cls0 + lane] = class_user;
    a.class_gc[cls0 + lane] = class_gc;
  }
  if (lane == 0) {
    // user writes advance with t: one each per written step
    a.user_writes[v] = wrap_add(a.user_writes[v], wrap_sub(t, a.t[v]));
    a.t[v] = t;
    a.total_occ[v] = total_occ;
    a.total_valid[v] = total_valid;
    a.gc_writes[v] = gc_writes;
    a.reclaimed[v] = reclaimed;
    a.overflow[v] = overflow;
    a.nc[v] = nc;
    a.ell[v] = ell;
    a.ell_tot[v] = ell_tot;
    a.lat_dens[v] = lat_dens;
    if (kTiming) {
      a.lat_now[v] = tm.now;
      a.lat_busy[v] = tm.busy;
      a.lat_debt[v] = tm.debt;
      a.lat_charged[v] = tm.charged;
      a.lat_sum[v] = tm.sum;
      a.lat_max[v] = tm.max;
    }
    if (stateful) {
      stateful_ops::store_scalars(scheme, sc, a.sch_sfs_since + v, a.sch_sfs_ready + v,
                                  a.sch_sfs_bounds + v * stateful_ops::kBounds,
                                  a.sch_sfr_prev + v,
                                  a.sch_warcip_cent + v * stateful_ops::kCentroids,
                                  a.sch_warcip_cnt + v * stateful_ops::kCentroids);
    }
  }
}

// One instance: its launch, or (`occupancy` not null) its resident blocks
// per SM, registers and local-memory bytes a thread.
template <bool kTiming, bool kDefer, bool kStateful, bool kSharedMeta, bool kPaper>
int run_instance(const ReplayArgs& a, const WarpLayout& L, cudaStream_t st, int* occupancy) {
  const size_t smem = static_cast<size_t>(a.warps) * L.total;
  auto* kernel = replay_kernel<kTiming, kDefer, kStateful, kSharedMeta, kPaper>;
  // the CUDA runtime sizes the shared-memory carveout for the occupancy,
  // so the rest of the SM's 256 KB stays L1 (spills, the victim's slots)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy != nullptr) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], kernel, 32 * a.warps,
                                                          smem);
    }
    occupancy[1] = attr.numRegs;
    occupancy[2] = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(err);
  }
  kernel<<<(a.n_volumes + a.warps - 1) / a.warps, 32 * a.warps, smem, st>>>(a, L);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTiming, bool kDefer, bool kPaper>
int run_stateful_or_not(const ReplayArgs& a, const WarpLayout& L, cudaStream_t st,
                        int* occupancy) {
  if (a.stateful) {
    return a.shared_meta ? run_instance<kTiming, kDefer, true, true, kPaper>(a, L, st, occupancy)
                         : run_instance<kTiming, kDefer, true, false, kPaper>(a, L, st,
                                                                             occupancy);
  }
  return a.shared_meta ? run_instance<kTiming, kDefer, false, true, kPaper>(a, L, st, occupancy)
                       : run_instance<kTiming, kDefer, false, false, kPaper>(a, L, st,
                                                                            occupancy);
}

int run(const ReplayArgs& a, cudaStream_t st, int* occupancy) {
  const WarpLayout L = warp_layout(a.seg_size, a.n_rows, a.n_classes, a.stateful != 0,
                                   a.shared_meta != 0);
  if (a.warps < 1 || a.warps > kMaxWarps || a.smem_per_warp != L.total ||
      a.seg_size > kMaxSegSize || a.n_classes > kMaxClasses || a.gc_batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.gc_batch > 1 || a.fifo) {   // the kPaper instances: greedy GC, timing off
    if (a.timing || a.defer) return static_cast<int>(cudaErrorInvalidValue);
    return run_stateful_or_not<false, false, true>(a, L, st, occupancy);
  }
  if (a.timing && a.defer) return run_stateful_or_not<true, true, false>(a, L, st, occupancy);
  if (a.timing) return run_stateful_or_not<true, false, false>(a, L, st, occupancy);
  if (a.defer) return run_stateful_or_not<false, true, false>(a, L, st, occupancy);
  return run_stateful_or_not<false, false, false>(a, L, st, occupancy);
}

}  // namespace

// Largest segment size and class-slot count the kernel takes (its shared
// scratch and one lane per class slot).
extern "C" int replay_limits(int* max_seg_size, int* max_classes) {
  *max_seg_size = kMaxSegSize;
  *max_classes = kMaxClasses;
  return 0;
}

// Replays a (V, T) trace through the state named in `args`, in place,
// `args->warps` volumes per block, one warp each. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue, launching nothing,
// when the geometry in `args` is not the kernel's).
extern "C" int replay_launch(const ReplayArgs* args, void* stream) {
  if (args->n_volumes <= 0) return static_cast<int>(cudaGetLastError());
  return run(*args, static_cast<cudaStream_t>(stream), nullptr);
}

// For the instance and geometry `args` name: out[0] its resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its registers a
// thread, out[2] its local memory a thread (spills and stack). Launches
// nothing.
extern "C" int replay_occupancy(const ReplayArgs* args, int* out) {
  return run(*args, nullptr, out);
}
