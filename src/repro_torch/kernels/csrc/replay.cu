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
// warp (one block of 32 threads) replays one volume from its first step to
// its last; no host decision is left.
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
//     this step: the victim argmax (none: the volume stalls for the step),
//     then the rewrite of `_gc_once`: ℓ bookkeeping, the victim slots'
//     classes, per-class ranks in slot order, the first C free rows (class c
//     takes the c-th whether it needs one or not), destinations, per-class
//     metadata, the victim's release, the counters.
// Where several writes of one scatter of the step engine hit one element
// (only when the free pool is exhausted and classes alias the pad row), the
// last in slot or class order wins, as in the step engine on the CPU.
//
// What bounds it on this card: the chain of dependent memory round trips of
// each volume (a user write reads its LBA's location, then its class's open
// segment; a GC iteration scores every row, reads the victim's slots, scans
// for free rows), far above the bytes the replay must move (the trace, and
// the state read and written once). The kernel is latency bound, one warp
// per volume, with as many volumes side by side as the fleet has. Each GC
// iteration scores every row of its volume, 16 B a row, so the victim
// scan's cost per user write grows with the volume's row count and, at
// large volumes, outweighs the user writes (chip_smoke.py's [scale] phase
// measures it).
//
// Design: per-volume scalars, the open segment of each class and the class
// counters live in registers for the whole replay (lane c holds class c);
// segment metadata, slots and the location map stay in global memory (the
// metadata of 744 volumes x 363 rows is 6.5 MB and stays in L2), so shared
// memory caps no volume's size (the victim scan's time grows with it).
// Shared memory holds only the warp's scratch: the victim's slots (read
// whole before any move, as the step engine gathers them) and the free rows. Ranks come from one ballot per class; duplicate targets are
// resolved with __match_any_sync so the highest slot (or class) writes. Fill
// counts that several lanes may add to (the pad row) use atomicAdd. The trace
// is read 32 steps at a time by the warp; the per-step GC iteration count
// goes to a (T,) buffer with atomicMax, so the host learns the tick counts
// with one read after the launch.
//
// The timing model and the GC schedules (jaxsim's cfg.timing and p_gcsched;
// torchsim._user_latency, _gc_deferred, _charge_gc) come in two template
// flags, so that the instance with both off is the code above:
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
//     previous LBA, warcip's centroids) stay in registers. sfs refreshes its
//     bounds from exact order statistics of the hotness of the volume's
//     seen LBAs, written once per refresh into a scratch with one (n_lbas,)
//     row per sfs volume (its slot: the sfs volumes before it). The
//     elementwise volumes of such a fleet run the code above.
// Every float op is a round-to-nearest intrinsic and the build has no fused
// multiply-add, so the lat_* and sch_* keys equal the plain version's bit for bit
// (logf can differ from the CPU's log by an ulp: only a latency within an
// ulp of a bucket edge would see it).

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
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 32;   // one lane per class slot
constexpr int kScanRows = 4;      // rows each lane loads per round of a free-row scan
constexpr int kRateLimited = 1;   // config.GCSCHED_IDS
constexpr int kIdleWindow = 2;

// One volume's arrays.
struct Volume {
  int* lba;
  int* utime;
  unsigned char* valid;
  int* n;
  int* nvalid;
  int* cls;
  int* state;
  int* ctime;
  int* stime;
  int* loc_seg;
  int* loc_off;
  int* last_uw;
};

// int32 subtraction that wraps like the reference's
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// True in the highest lane among those whose `key` matches this lane's.
// Every lane of the warp must call it.
template <typename K>
__device__ __forceinline__ bool highest_of_group(K key, int lane) {
  return ((__match_any_sync(kFull, key) >> lane) >> 1) == 0;
}

// The first `want` rows with state 0 (free), ascending, into out[0, want);
// the pad row past the end of the free pool. Every lane must call it.
__device__ __forceinline__ void first_free_rows(const int* state, int n_rows, int pad, int want,
                                                int* out, int lane) {
  int found = 0;
  for (int base = 0; base < n_rows && found < want; base += 32 * kScanRows) {
    int st[kScanRows];
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const int r = base + k * 32 + lane;
      st[k] = r < n_rows ? state[r] : -1;
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

// The victim argmax of segsel.cu over one volume's rows, reduced across the
// warp (every lane gets it): -1 when no row is eligible.
__device__ __forceinline__ int select_victim(const Volume& vol, int n_rows, int t, int selector,
                                             int lane) {
  float best = -INFINITY;
  int best_i = INT_MAX;
#pragma unroll 4
  for (int j = lane; j < n_rows; j += 32) {
    const float s = engine_ops::score_one(vol.n[j], vol.nvalid[j], vol.stime[j], vol.state[j],
                                          t, selector);
    if (s > best) {  // j rises along the loop, so the first maximum stays
      best = s;
      best_i = j;
    }
  }
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

// Rows with state 0 (free) of one volume, summed across the warp.
__device__ __forceinline__ int count_free_rows(const int* state, int n_rows) {
  int count = 0;
  for (int j = threadIdx.x; j < n_rows; j += 32) count += state[j] == 0 ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  return count;
}

// Volumes before v that run sfs, summed across the warp: v's row of the
// refresh scratch, which holds one row per sfs volume.
__device__ __forceinline__ int sfs_slot(const int* p_scheme, int v) {
  int count = 0;
  for (int j = threadIdx.x; j < v; j += 32) count += p_scheme[j] == stateful_ops::kSfs ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  return count;
}

// One volume's rows of the stateful schemes' tables (the whole warp calls it).
__device__ __forceinline__ stateful_ops::Tables volume_tables(const ReplayArgs& a, int v,
                                                              int scheme) {
  const long long n = a.n_lbas;
  const long long n_ext = (n + stateful_ops::kEtiExtent - 1) / stateful_ops::kEtiExtent;
  const long long n_ch = (n + stateful_ops::kChunk - 1) / stateful_ops::kChunk;
  return {a.sch_fk_bit + v * n, a.sch_dac_region + v * n, a.sch_ml_count + v * n,
          a.sch_ml_level + v * n, a.sch_sfs_count + v * n, a.sch_sfs_first + v * n,
          scheme == stateful_ops::kSfs ? a.sfs_keys + sfs_slot(a.p_scheme, v) * n : nullptr,
          a.sch_eti_count + v * n_ext, a.sch_eti_last + v * n_ext,
          a.sch_mq_freq + v * n, a.sch_mq_level + v * n, a.sch_mq_expire + v * n,
          a.sch_sfr_freq + v * n_ch, a.sch_sfr_last + v * n_ch,
          a.sch_fadac_count + v * n_ch, a.sch_fadac_last + v * n_ch,
          a.sch_warcip_last + v * n, a.n_lbas, static_cast<int>(n_ext), a.seg_size,
          a.sfs_resample};
}

template <bool kTiming, bool kDefer, bool kStateful>
__global__ void __launch_bounds__(32) replay_kernel(const ReplayArgs a) {
  extern __shared__ int smem[];
  const int s = a.seg_size, R = a.n_rows, C = a.n_classes, pad = R - 1;
  const int lane = threadIdx.x;
  const int v = blockIdx.x;
  int* sh_free = smem;                       // kMaxClasses
  int* sh_lba = smem + kMaxClasses;          // s
  int* sh_utime = sh_lba + s;                // s
  int* sh_cls = sh_utime + s;                // s, kStateful only: the victim slots' classes
  unsigned char* sh_valid = reinterpret_cast<unsigned char*>(kStateful ? sh_cls + s
                                                                       : sh_utime + s);   // s

  const long long row0 = static_cast<long long>(v) * R;
  const long long lba0 = static_cast<long long>(v) * a.n_lbas;
  const Volume vol{a.seg_lba + row0 * s, a.seg_utime + row0 * s, a.seg_valid + row0 * s,
                   a.seg_n + row0, a.seg_nvalid + row0, a.seg_cls + row0,
                   a.seg_state + row0, a.seg_ctime + row0, a.seg_stime + row0,
                   a.loc_seg + lba0, a.loc_off + lba0, a.last_uw + lba0};

  // the volume's scalars, in registers for the whole replay
  int t = a.t[v], total_occ = a.total_occ[v], total_valid = a.total_valid[v];
  int user_writes = a.user_writes[v], gc_writes = a.gc_writes[v], reclaimed = a.reclaimed[v];
  int overflow = a.overflow[v], nc = a.nc[v];
  float ell = a.ell[v], ell_tot = a.ell_tot[v], lat_dens = a.lat_dens[v];
  const int scheme = a.p_scheme[v], selector = a.p_selector[v], ncw = a.p_ncw[v];
  const int live_classes = a.p_classes[v];
  const float gp_limit = a.p_gp[v];
  // the timing model's per-volume scalars and the GC schedule
  const int sched = (kTiming || kDefer) ? a.p_gcsched[v] : 0;
  float lat_now = 0.0f, lat_busy = 0.0f, lat_debt = 0.0f, lat_charged = 0.0f;
  float lat_sum = 0.0f, lat_max = 0.0f;
  int* const lat_hist = a.lat_hist + static_cast<long long>(v) * a.lat_buckets;
  if (kTiming) {
    lat_now = a.lat_now[v];
    lat_busy = a.lat_busy[v];
    lat_debt = a.lat_debt[v];
    lat_charged = a.lat_charged[v];
    lat_sum = a.lat_sum[v];
    lat_max = a.lat_max[v];
  }
  const bool deferring = kDefer && sched == kIdleWindow;
  int free_rows = deferring ? count_free_rows(vol.state, R) : 0;
  // lane c holds class slot c's open segment and counters
  const long long cls0 = static_cast<long long>(v) * C;
  const bool has_class = lane < C;
  int open_sid = has_class ? a.open_sid[cls0 + lane] : 0;
  int class_user = has_class ? a.class_user[cls0 + lane] : 0;
  int class_gc = has_class ? a.class_gc[cls0 + lane] : 0;
  // a stateful scheme's tables and its scalars (stateful_ops.cuh)
  const bool stateful = kStateful && stateful_ops::is_stateful(scheme);
  const bool reads_next = stateful && scheme == stateful_ops::kFk;
  stateful_ops::Tables tables{};
  stateful_ops::Scalars scalars{};
  if (stateful) {
    tables = volume_tables(a, v, scheme);
    stateful_ops::load_scalars(scheme, a.sch_sfs_since + v, a.sch_sfs_ready + v,
                               a.sch_sfs_bounds + v * stateful_ops::kBounds, a.sch_sfr_prev + v,
                               a.sch_warcip_cent + v * stateful_ops::kCentroids,
                               a.sch_warcip_cnt + v * stateful_ops::kCentroids, scalars);
  }

  const int* trace = a.trace + static_cast<long long>(v) * a.n_steps;
  const int* next_row = reads_next ? a.nxt + static_cast<long long>(v) * a.n_steps : nullptr;
  for (int base = 0; base < a.n_steps; base += 32) {
    const int ahead = base + lane < a.n_steps ? trace[base + lane] : -1;
    const int next_ahead = reads_next && base + lane < a.n_steps ? next_row[base + lane] : 0;
    const int n_here = min(32, a.n_steps - base);
    for (int k = 0; k < n_here; ++k) {
      const int lba = __shfl_sync(kFull, ahead, k);
      if (lba < 0) continue;    // a pad step of a shorter trace: no write, no GC
      __syncwarp();

      // ---- user write (torchsim._user_write) ----
      const int old_sid = vol.loc_seg[lba], old_off = vol.loc_off[lba];
      const int lifespan = wrap_sub(t, vol.last_uw[lba]);
      const bool had_old = old_sid >= 0;
      int cls;
      if (stateful) {   // the scheme's class, its tables updated (stateful.user_classes)
        const int next = reads_next ? __shfl_sync(kFull, next_ahead, k) : 0;
        cls = stateful_ops::user_class(scheme, tables, scalars, lba, t, next, lane);
      } else {
        cls = engine_ops::classify_one(scheme, ell, lifespan, 0, false, false);
      }
      const int sid = __shfl_sync(kFull, open_sid, cls);
      const int off = vol.n[sid];
      const int n_new = sid == pad ? min(off + 1, s) : off + 1;
      if (lane == 0) {
        if (had_old) {
          if (old_off < s) vol.valid[static_cast<long long>(old_sid) * s + old_off] = 0;
          atomicSub(&vol.nvalid[old_sid], 1);
        }
        if (off < s) {
          const long long at = static_cast<long long>(sid) * s + off;
          vol.lba[at] = lba;
          vol.utime[at] = t;
          vol.valid[at] = 1;
        }
        vol.n[sid] = n_new;
        atomicAdd(&vol.nvalid[sid], 1);
        vol.loc_seg[lba] = sid;
        vol.loc_off[lba] = off;
        vol.last_uw[lba] = t;
      }
      if (n_new >= s) {     // sealed: promote the first free row
        first_free_rows(vol.state, R, pad, 1, sh_free, lane);
        const int fresh = sh_free[0];
        if (lane == 0) {
          vol.state[sid] = 2;
          vol.stime[sid] = t;
          vol.state[fresh] = 1;
          vol.cls[fresh] = cls;
          vol.ctime[fresh] = t;
        }
        if (lane == cls) open_sid = fresh;
        overflow += fresh == pad ? 1 : 0;
        if (deferring) free_rows -= fresh == pad ? 0 : 1;
      }
      lat_dens = __fadd_rn(__fmul_rn(lat_dens, a.dens_keep), a.dens_add);
      if (kTiming) {   // torchsim._user_latency
        const float arrive = lat_now;
        const float latency = __fadd_rn(fmaxf(__fsub_rn(lat_busy, arrive), 0.0f), a.write_cost);
        // a write that waited for nothing has the ratio 1 and bucket 0
        // (logf(1) is exactly 0): most writes skip the logarithm
        float b = 0.0f;
        if (latency != a.write_cost) {
          const float log2 = __fdiv_rn(logf(__fdiv_rn(latency, a.write_cost)), a.ln2);
          b = fminf(fmaxf(floorf(__fmul_rn(4.0f, log2)), 0.0f), __int2float_rn(a.lat_buckets - 1));
        }
        lat_now = __fadd_rn(arrive, latency);
        lat_sum = __fadd_rn(lat_sum, latency);
        lat_max = fmaxf(lat_max, latency);
        if (lane == 0) atomicAdd(&lat_hist[__float2int_rz(b)], 1);
      }
      t += 1;
      total_occ += 1;
      total_valid += had_old ? 0 : 1;
      user_writes += 1;
      if (lane == cls) class_user += 1;
      __syncwarp();

      // ---- GC loop (torchsim.fleet_gc_tick, one volume) ----
      int iters = 0;
      for (int it = 0; it < a.max_gc; ++it) {
        const float occ = __int2float_rn(max(total_occ, 1));
        const float gp = __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(total_valid), occ));
        if (!(gp > gp_limit)) break;
        if (deferring && lat_dens > a.idle_density && free_rows >= a.watermark_rows) break;
        ++iters;
        const int victim = select_victim(vol, R, t, selector, lane);
        if (victim < 0) break;    // stalled for the rest of this step

        // ---- rewrite the victim (torchsim._gc_once) ----
        const long long vslot0 = static_cast<long long>(victim) * s;
        const int k_total = vol.nvalid[victim], victim_n = vol.n[victim];
        const int victim_cls = vol.cls[victim], victim_ctime = vol.ctime[victim];
        for (int j = lane; j < s; j += 32) {
          sh_lba[j] = vol.lba[vslot0 + j];
          sh_utime[j] = vol.utime[vslot0 + j];
          sh_valid[j] = vol.valid[vslot0 + j];
        }
        const int n0 = has_class ? vol.n[open_sid] : 0;
        first_free_rows(vol.state, R, pad, C, sh_free, lane);   // syncs the warp
        const int free_row = has_class ? sh_free[lane] : pad;

        // ℓ bookkeeping (Algorithm 1 lines 4-9)
        const bool is_c1 = victim_cls == 0;
        nc += is_c1 ? 1 : 0;
        const float life = __int2float_rn(wrap_sub(t, victim_ctime));
        ell_tot = __fadd_rn(ell_tot, is_c1 ? life : 0.0f);
        if (nc >= ncw) {
          ell = __fdiv_rn(ell_tot, __int2float_rn(max(nc, 1)));
          nc = 0;
          ell_tot = 0.0f;
        }

        if (kStateful) {
          // every slot's class before any table changes (stateful.gc_classes
          // reads them all, then dac and ml write theirs): -1 for a dead slot
          for (int j = lane; j < s; j += 32) {
            const bool live = sh_valid[j] != 0;
            sh_cls[j] = !live ? -1
                        : stateful ? stateful_ops::gc_class(scheme, tables, scalars, sh_lba[j], t)
                                   : engine_ops::classify_one(scheme, ell, 0,
                                                              wrap_sub(t, sh_utime[j]), is_c1,
                                                              true);
          }
          __syncwarp();
          if (stateful) stateful_ops::gc_update(scheme, tables, sh_lba, sh_cls, s, lane);
        }

        // classes, ranks and destinations of the victim's slots, 32 at a time
        const int room = max(s - n0, 0);
        int per_cls = 0;    // lane c: live slots of class c so far
        for (int b = 0; b < s; b += 32) {
          const int j = b + lane;
          const bool live = j < s && sh_valid[j] != 0;
          const int blk = j < s ? sh_lba[j] : 0;
          const int ut = j < s ? sh_utime[j] : 0;
          const int c = !live ? -1
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
          const long long at = put ? static_cast<long long>(dst_sid) * s + dst_off : -1 - lane;
          if (highest_of_group(at, lane) && put) {
            vol.lba[at] = blk;
            vol.utime[at] = ut;
            vol.valid[at] = 1;
          }
          if (highest_of_group(live ? blk : -1 - lane, lane) && live) {
            vol.loc_seg[blk] = dst_sid;
            vol.loc_off[blk] = dst_off;
          }
          __syncwarp();
        }

        // per-class metadata: fill counts, first-block time, seal-if-full,
        // promote-fresh; padded class slots (>= p_classes) count no blocks
        const int took1 = min(per_cls, room), took2 = per_cls - took1;
        const bool sealed = has_class && lane < live_classes && n0 + took1 >= s;
        if (has_class) {
          if (took1 > 0) {
            atomicAdd(&vol.n[open_sid], took1);
            atomicAdd(&vol.nvalid[open_sid], took1);
          }
          if (took2 > 0) {
            atomicAdd(&vol.n[free_row], took2);
            atomicAdd(&vol.nvalid[free_row], took2);
          }
          if (n0 == 0 && per_cls > 0) vol.ctime[open_sid] = t;
          if (sealed) {
            vol.state[open_sid] = 2;
            vol.stime[open_sid] = t;
          }
        }
        __syncwarp();
        if (highest_of_group(sealed ? free_row : -1 - lane, lane) && sealed) {
          vol.state[free_row] = 1;
          vol.cls[free_row] = lane;
          vol.ctime[free_row] = t;
        }
        const bool pad_fill = has_class && ((open_sid == pad && took1 > 0) ||
                                            (free_row == pad && took2 > 0));
        overflow += __popc(
            __ballot_sync(kFull, has_class && free_row == pad && (took2 > 0 || sealed)));
        if (deferring) {   // the free rows promoted, and the victim released below
          free_rows -= __popc(__ballot_sync(kFull, sealed && free_row != pad));
          free_rows += victim == pad ? 0 : 1;
        }
        if (sealed) open_sid = free_row;
        const bool cap_pad = __any_sync(kFull, pad_fill);
        __syncwarp();
        if (cap_pad && lane == 0 && vol.n[pad] > s) vol.n[pad] = s;
        __syncwarp();

        // release the victim; the pad row returns to reserved state 3
        if (lane == 0) {
          vol.state[victim] = victim == pad ? 3 : 0;
          vol.n[victim] = 0;
          vol.nvalid[victim] = 0;
        }
        for (int j = lane; j < s; j += 32) vol.valid[vslot0 + j] = 0;
        __syncwarp();
        total_occ = total_occ - victim_n + k_total;
        gc_writes += k_total;
        reclaimed += 1;
        class_gc += per_cls;
        if (kTiming) {   // the rewrite's device time, booked as debt
          lat_debt = __fadd_rn(lat_debt, __fmul_rn(__int2float_rn(k_total), a.gc_block_cost));
        }
      }
      if (lane == 0 && iters > 0) atomicMax(&a.iterations[base + k], iters);
      if (kTiming) {   // torchsim._charge_gc, after the step's GC loop
        const float charge = sched == kRateLimited ? fminf(lat_debt, a.charge_cap) : lat_debt;
        lat_busy = __fadd_rn(fmaxf(lat_busy, lat_now), charge);
        lat_debt = __fsub_rn(lat_debt, charge);
        lat_charged = __fadd_rn(lat_charged, charge);
      }
    }
  }

  if (lane == 0) {
    a.t[v] = t;
    a.total_occ[v] = total_occ;
    a.total_valid[v] = total_valid;
    a.user_writes[v] = user_writes;
    a.gc_writes[v] = gc_writes;
    a.reclaimed[v] = reclaimed;
    a.overflow[v] = overflow;
    a.nc[v] = nc;
    a.ell[v] = ell;
    a.ell_tot[v] = ell_tot;
    a.lat_dens[v] = lat_dens;
    if (kTiming) {
      a.lat_now[v] = lat_now;
      a.lat_busy[v] = lat_busy;
      a.lat_debt[v] = lat_debt;
      a.lat_charged[v] = lat_charged;
      a.lat_sum[v] = lat_sum;
      a.lat_max[v] = lat_max;
    }
  }
  if (has_class) {
    a.open_sid[cls0 + lane] = open_sid;
    a.class_user[cls0 + lane] = class_user;
    a.class_gc[cls0 + lane] = class_gc;
  }
  if (stateful && lane == 0) {
    stateful_ops::store_scalars(scheme, scalars, a.sch_sfs_since + v, a.sch_sfs_ready + v,
                                a.sch_sfs_bounds + v * stateful_ops::kBounds, a.sch_sfr_prev + v,
                                a.sch_warcip_cent + v * stateful_ops::kCentroids,
                                a.sch_warcip_cnt + v * stateful_ops::kCentroids);
  }
}

template <bool kTiming, bool kDefer, bool kStateful>
int launch_instance(const ReplayArgs& a, size_t smem, cudaStream_t st) {
  auto* kernel = replay_kernel<kTiming, kDefer, kStateful>;
  if (smem > 48 * 1024) {   // past the default cap of dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.n_volumes, 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTiming, bool kDefer>
int launch_stateful_or_not(const ReplayArgs& a, size_t smem, cudaStream_t st) {
  return a.stateful ? launch_instance<kTiming, kDefer, true>(a, smem, st)
                    : launch_instance<kTiming, kDefer, false>(a, smem, st);
}

}  // namespace

// Largest segment size and class-slot count the kernel takes (its shared
// scratch and one lane per class slot).
extern "C" int replay_limits(int* max_seg_size, int* max_classes) {
  *max_seg_size = 4096;
  *max_classes = kMaxClasses;
  return 0;
}

// Replays a (V, T) trace through the state named in `args`, in place, one
// block of one warp per volume. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int replay_launch(const ReplayArgs* args, void* stream) {
  if (args->n_volumes <= 0) return static_cast<int>(cudaGetLastError());
  const ReplayArgs& a = *args;
  // the victim's LBAs, times (and, for kStateful, classes) as ints, its valid flags as bytes
  const size_t smem =
      sizeof(int) * (kMaxClasses + (a.stateful ? 3 : 2) * a.seg_size) + a.seg_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.timing && a.defer) return launch_stateful_or_not<true, true>(a, smem, st);
  if (a.timing) return launch_stateful_or_not<true, false>(a, smem, st);
  if (a.defer) return launch_stateful_or_not<false, true>(a, smem, st);
  return launch_stateful_or_not<false, false>(a, smem, st);
}
