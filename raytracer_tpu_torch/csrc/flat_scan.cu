// The flat closest-hit scan on Hopper: one spp chunk for every lane of a
// lane->pixel map, every bounce testing every sphere of the scene.
//
// Replaces the flat-scan variants of the TPU kernel
// raytracer_tpu/render/pallas_kernel.py `_make_kernel(...).kernel`
// (launched by `_render_chunk_impl`, `cdims=None`): K2, the scan with the
// near->far root fallback on every slot (`g_full >= s_pad`), and K2s, the
// split scan (`g_full < s_pad`): full logic on slots [0, g_full), the
// near root alone on the rest, and an exact far-root self-test of the
// sphere the lane last bounced off. Four template parameters give ten
// instantiations (each built in two scan forms, below):
//   kAdaptive, kStratified  as in cluster_walk.cu (per-lane budget and two
//                           more output rows; Kronecker camera and
//                           first-bounce draws);
//   kSplit                  K2s;
//   kDebug                  the overlay of the shared tail (K3); the
//                           winner's uuid is its slot. Debug renders keep
//                           the scene's own slot order (no split) and
//                           strip the adaptive tolerance, so only
//                           <false, s, false, true> exist.
// The JAX package's `scan_mxu` variant (K2m, an MXU offload of the scan's
// dot products in bf16) computes K2's function and is served by K2 in
// exact float32.
//
// Design. Each thread runs the path-regeneration state machine for one
// lane at a time, one bounce per loop trip (segments and the cost tick
// count once per trip, as the TPU kernel counts them). The sphere table,
// 12 floats a slot, sits in shared memory; every lane of a warp reads the
// same row at the same time, a broadcast, [cx, cy, cz, k1] in one 16-byte
// load. The running minimum with strict < keeps the lowest slot of equal
// candidates, where the TPU's one-hot gather summed the parameters of
// every tied slot. K2s carries the last-hit slot index and reads its row
// from shared memory, where the TPU kernel carried 11 gathered floats:
// the same values in fewer registers.
//
// What bounds it on this card: FP32 issue once the warps are full (about
// 20 instructions a slot whose discriminant is negative, 48 with the
// root, a few hundred a bounce in the tail), and lanes idle in their
// warp. What the design does about it, each element kept on an A/B on
// the card (PERF.md):
//   - One block of 1024 threads an SM, persistent: one copy of the table
//     an SM, and a thread whose lane has taken its samples takes the next
//     lane of the map (common.cuh `first_lane`, `next_lane`), so a warp
//     stays full until the map runs out. The refill is an if-region the
//     warp's lanes leave together: as the loop's `continue` path, the
//     warp's lanes drifted apart and K2s adaptive ran 4.5 times slower.
//   - An exact early rejection: a slot whose discriminant is negative
//     takes no root. Its candidate is exactly kFillQ (a negative float32
//     difference of a finite square means |nb| < 2^64, so nb + 3e38
//     rounds to 3e38), which never beats the running minimum.
//   - In tables of kBatchedMin slots or more, slots in batches of kBatch:
//     the batch's discriminants are independent chains the scheduler
//     interleaves, and one branch a batch skips the roots where every
//     lane of the warp rejects every slot (98 % of the cover's slots).
//     Smaller tables, whose slots mostly have a root somewhere in the
//     warp, take one slot at a time (the form is a template parameter
//     the launcher picks by the table's size, at the cut kBatchedMin
//     that the two forms' times on tables of 9-63 slots give).
// Device memory sees only the tables, the map, the lane counter and one
// write per lane and row.
//
// Numerics follow the plain PyTorch version
// (raytracer_tpu_torch/render/flat_scan.py) operation for operation:
// build with -fmad=false and without --use_fast_math.

#include "common.cuh"

namespace {

using namespace rt;

constexpr int kRow = 12;  // [cx, cy, cz, k1, 1/r, mat, albedo rgb, fuzz, ior, active]

// one block of 1024 threads an SM: ptxas keeps the kernel within 64
// registers a thread, 32 warps an SM
constexpr int kFlatThreads = 1024;
constexpr int kBatch = 8;  // slots whose discriminants go together
// tables of this many slots or more are scanned in batches, smaller ones
// slot by slot: the cut raytracer_tpu_torch/scripts/walk_ab.py's form
// sweep reads from the two forms' times, each built for every table size
// with RT_FLAT_BATCHED_MIN (1024: slot by slot, 1: in batches). On an
// H100's 1080p frame the batched form was 5-19 % faster from 16 slots to
// 63 and 1-2 % slower on the demo's 9 (PERF.md)
#ifndef RT_FLAT_BATCHED_MIN
#define RT_FLAT_BATCHED_MIN 16
#endif
constexpr int kBatchedMin = RT_FLAT_BATCHED_MIN;

struct Params {
  PathParams path;
  const float* camera;   // (19,) origin, llc, horizontal, vertical, u, v, lens
  const float* spheres;  // (slots, 12) rows as kRow says
  const int* pixel_map;  // (n, 2) [px, py]
  const int* budget;     // (n,) samples per lane, or null: spp for every lane
  float* out;            // (4, n) rgb sums and bounces, lane order;
                         // (6, n) with sample count and sum of lum^2
  int* segs;             // (n,) completed bounces
  int* next_lane;        // lanes taken past the grid's own, zeroed by the
                         // launch on its stream
  int n, slots;
  int g_full;            // slots [0, g_full) take the full root logic
  DebugUniforms dbg;     // kDebug: cursor point and selection
};

// Counters of the scan's structure, compiled in only with
// -DRT_FLAT_COUNTERS (raytracer_tpu_torch/scripts/walk_ab.py builds it;
// the main path's build never does). Where a warp's active lanes pass,
// the lowest counts the warp; every lane counts itself.
enum FlatCounter {
  kWarpTrips,    // bounce-loop trips of a warp
  kLaneTrips,    // bounce-loop trips of a lane (completed bounces)
  kWarpSlots,    // slot iterations of a warp, full and near-root loops
  kLaneSlots,    // slot iterations of a lane
  kWarpRoot,     // warp slot iterations where some active lane's
                 // discriminant is not negative (the warp takes a root)
  kLaneRoot,     // lane slot iterations whose discriminant is not negative
  kWarpTail,     // warp runs of the bounce tail
  kLaneTail,     // lane runs of the bounce tail
  kLaneRefill,   // lanes a thread took after its first
  kWarpBatch,    // slot batches of a warp
  kWarpBatchRoot,  // slot batches where the warp runs the root logic
  kNumCounters
};
constexpr int kLiveBins = 33;  // active lanes of a warp trip, 0..32

// A thread's counts: empty, and free, unless the counter build.
struct Counts {
#ifdef RT_FLAT_COUNTERS
  unsigned long long c[kNumCounters];
#endif
};

#ifdef RT_FLAT_COUNTERS
__device__ unsigned long long g_counters[kNumCounters];
__device__ unsigned long long g_live[kLiveBins];
#define RT_LEADER                                                      \
  const unsigned act_ = __activemask();                                \
  const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1
#define RT_COUNT(k, v) (cnt.c[k] += (v))
#define RT_WARP_COUNT(k, pred)                                         \
  do {                                                                 \
    const unsigned any_ = __ballot_sync(act_, (pred));                 \
    cnt.c[k] += (leader_ && any_ != 0u) ? 1u : 0u;                     \
  } while (0)
// one slot iteration, and whether its discriminant ds is not negative
#define RT_COUNT_SLOT(ds)                                              \
  do {                                                                 \
    RT_LEADER;                                                         \
    const bool root_ = !((ds) < 0.0f);                                 \
    RT_COUNT(kLaneSlots, 1u);                                          \
    RT_COUNT(kLaneRoot, root_ ? 1u : 0u);                              \
    RT_COUNT(kWarpSlots, leader_ ? 1u : 0u);                           \
    RT_WARP_COUNT(kWarpRoot, root_);                                   \
  } while (0)
#else
#define RT_COUNT(k, v) ((void)0)
#define RT_COUNT_SLOT(ds) ((void)0)
#endif

__device__ __forceinline__ float4 row4(const float* s_tab, int j) {
  return *reinterpret_cast<const float4*>(s_tab + kRow * j);
}

// The root logic of one slot of discriminant ds: the near root, with
// kFull the far root where the near one lies below min_t_a, kept where it
// is at least min_t_a and strictly below the best. This is the running
// minimum over common.cuh's exact_q (or the near root alone): a candidate
// below min_t_a is kFillQ there, which never beats the best.
template <bool kFull>
__device__ __forceinline__ void take_root(float nb, float ds, float min_t_a,
                                          int j, float& bq, int& bs) {
  const float sq = root_of(ds);
  const float qn = nb - sq;
  const float q = kFull ? (qn >= min_t_a ? qn : nb + sq) : qn;
  if (q >= min_t_a && q < bq) {
    bq = q;
    bs = j;
  }
}

// The ray a bounce tests against every slot.
struct Ray {
  float ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, min_t_a;
};

__device__ __forceinline__ void ray_disc(const Ray& r, float4 c, float& nb,
                                         float& ds) {
  discriminant(c.x, c.y, c.z, c.w, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.a,
               r.o_dot_d, r.o_dot_o, nb, ds);
}

// Slots [j0, j1) one at a time, each with its root logic (the compiler
// branches round the square root where the warp's discriminants are all
// negative).
template <bool kFull>
__device__ __forceinline__ void scan_each(const float* s_tab, int j0, int j1,
                                          const Ray& r, float& bq, int& bs,
                                          Counts& cnt) {
  for (int j = j0; j < j1; ++j) {
    float nb, ds;
    ray_disc(r, row4(s_tab, j), nb, ds);
    RT_COUNT_SLOT(ds);
    take_root<kFull>(nb, ds, r.min_t_a, j, bq, bs);
  }
}

// The closest candidate over slots [j0, j1) into (bq, bs), kFull taking
// the near->far logic and else the near root alone, slots in ascending
// order; kBatched in batches, where a slot with a negative discriminant
// is skipped: its candidate, kFillQ, cannot beat bq.
template <bool kFull, bool kBatched>
__device__ __forceinline__ void scan_slots(const float* s_tab, int j0,
                                           int j1, const Ray& r, float& bq,
                                           int& bs, Counts& cnt) {
  if (!kBatched) {
    scan_each<kFull>(s_tab, j0, j1, r, bq, bs, cnt);
    return;
  }
  int j = j0;
  for (; j + kBatch <= j1; j += kBatch) {
    float nb[kBatch], ds[kBatch];
    bool miss = true;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      ray_disc(r, row4(s_tab, j + k), nb[k], ds[k]);
      RT_COUNT_SLOT(ds[k]);
      miss = miss & (ds[k] < 0.0f);
    }
#ifdef RT_FLAT_COUNTERS
    {
      RT_LEADER;
      RT_COUNT(kWarpBatch, leader_ ? 1u : 0u);
      RT_WARP_COUNT(kWarpBatchRoot, !miss);
    }
#endif
    if (!miss) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (!(ds[k] < 0.0f))
          take_root<kFull>(nb[k], ds[k], r.min_t_a, j + k, bq, bs);
    }
  }
  scan_each<kFull>(s_tab, j, j1, r, bq, bs, cnt);
}

template <bool kAdaptive, bool kStratified, bool kSplit, bool kDebug,
          bool kBatched>
__global__ void __launch_bounds__(kFlatThreads, 1)
    flat_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_cam = smem;       // 19, padded to 20: the rows stay 16-byte aligned
  float* s_tab = smem + 20;  // slots * kRow
  for (int j = threadIdx.x; j < 19; j += blockDim.x) s_cam[j] = p.camera[j];
  for (int j = threadIdx.x; j < kRow * p.slots; j += blockDim.x)
    s_tab[j] = p.spheres[j];
  __syncthreads();

  const uint32_t dps = 4u + (uint32_t)p.path.max_depth * kDrawsPerBounce;
  const int g_full = kSplit ? p.g_full : p.slots;
  int lane = first_lane();
  float px, py;
  uint32_t pix;
  int limit;  // samples this lane takes
  Path path;
  Sums sums;
  float cost;
  int segs;
  int last = 0;  // K2s: the slot this lane last bounced off
  Counts cnt = {};
  for (;;) {
    if (lane >= p.n) return;
    if (lane_setup<kAdaptive>(p.path, p.pixel_map, p.budget, p.out, p.segs,
                              p.n, lane, px, py, pix, limit))
      break;
    lane = next_lane(p.next_lane);
  }
  path.s = 0;
  start_sample<kStratified>(s_cam, p.path, dps, px, py, pix, path);
  sums = {0.0f, 0.0f, 0.0f, 0.0f};
  cost = 0.0f;
  segs = 0;

  for (;;) {
    cost += 1.0f;
    ++segs;
#ifdef RT_FLAT_COUNTERS
    {
      RT_LEADER;
      RT_COUNT(kWarpTrips, leader_ ? 1u : 0u);
      RT_COUNT(kLaneTrips, 1u);
      if (leader_) atomicAdd(&g_live[__popc(act_)], 1ull);
    }
#endif
    Ray r;
    r.ox = path.ox, r.oy = path.oy, r.oz = path.oz;
    r.dx = path.dx, r.dy = path.dy, r.dz = path.dz;
    r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    r.o_dot_d = dot3(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
    r.o_dot_o = dot3(r.ox, r.oy, r.oz, r.ox, r.oy, r.oz);
    r.min_t_a = kMinT * r.a;

    // the closest candidate over every slot; strict < keeps the lowest
    // slot of equal candidates
    float bq = kFillQ;
    int bs = 0;
    scan_slots<true, kBatched>(s_tab, 0, g_full, r, bq, bs, cnt);
    if (kSplit) {
      scan_slots<false, kBatched>(s_tab, g_full, p.slots, r, bq, bs, cnt);
      // the far root of the sphere the origin sits on, mid-path only;
      // strict <: a containable winner that ties bitwise keeps its slot
      if (path.i >= 1) {
        float nb, ds;
        ray_disc(r, row4(s_tab, last), nb, ds);
        const float qf = nb + root_of(ds);
        if (qf >= r.min_t_a && qf < bq) {
          bq = qf;
          bs = last;
        }
      }
    }
#ifdef RT_FLAT_COUNTERS
    {
      RT_LEADER;
      RT_WARP_COUNT(kWarpTail, true);
      RT_COUNT(kLaneTail, 1u);
    }
#endif

    const float* row = s_tab + kRow * bs;
    const int res = bounce_tail<kAdaptive, kStratified, kDebug>(
        p.path, s_cam, row, row + 4, bq, 1.0f / r.a, pix, dps,
        (uint32_t)(p.path.sample_offset + path.s) * dps + 4u +
            (uint32_t)path.i * kDrawsPerBounce,
        px, py, limit, kDebug ? (float)bs : 0.0f, p.dbg, path, sums);
    if (kSplit && res == kPathGoesOn) last = bs;
    if (res == kLaneDone) {
      write_lane<kAdaptive>(p.out, p.segs, p.n, lane, sums, cost, path,
                            segs);
      for (;;) {
        lane = next_lane(p.next_lane);
        if (lane >= p.n) break;
        if (lane_setup<kAdaptive>(p.path, p.pixel_map, p.budget, p.out,
                                  p.segs, p.n, lane, px, py, pix, limit))
          break;
      }
      if (lane < p.n) {
        RT_COUNT(kLaneRefill, 1u);
        path.s = 0;
        start_sample<kStratified>(s_cam, p.path, dps, px, py, pix, path);
        sums = {0.0f, 0.0f, 0.0f, 0.0f};
        cost = 0.0f;
        segs = 0;
      }
    }
    if (lane >= p.n) break;
  }
#ifdef RT_FLAT_COUNTERS
  for (int k = 0; k < kNumCounters; ++k) atomicAdd(&g_counters[k], cnt.c[k]);
#endif
}

template <bool kAdaptive, bool kStratified, bool kSplit, bool kDebug,
          bool kBatched>
cudaError_t launch_form(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel =
      flat_scan_kernel<kAdaptive, kStratified, kSplit, kDebug, kBatched>;
  // persistent: as many blocks as fit on every SM at once. That count
  // depends only on the instantiation, the device and the table's size:
  // worked out again only when one changes.
  static int set_dev = -1, grid_max = 0;
  static size_t set_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_dev || smem != set_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kFlatThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    set_dev = dev;
    set_smem = smem;
    grid_max = per_sm * sms;
  }
  int blocks = (p.n + kFlatThreads - 1) / kFlatThreads;
  if (blocks > grid_max) blocks = grid_max;
  err = cudaMemsetAsync(p.next_lane, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFlatThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the scan's form from the table: slot by slot below kBatchedMin slots,
// in batches from there
template <bool kAdaptive, bool kStratified, bool kSplit, bool kDebug>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  return p.slots >= kBatchedMin
             ? launch_form<kAdaptive, kStratified, kSplit, kDebug, true>(
                   p, smem, stream)
             : launch_form<kAdaptive, kStratified, kSplit, kDebug, false>(
                   p, smem, stream);
}

template <bool kAdaptive, bool kStratified>
cudaError_t launch_split(const Params& p, int split, size_t smem,
                         cudaStream_t st) {
  return split ? launch<kAdaptive, kStratified, true, false>(p, smem, st)
               : launch<kAdaptive, kStratified, false, false>(p, smem, st);
}

// shared memory of one block for a table of `slots` rows, in bytes (the
// caller checks the same size against the card's default limit)
size_t smem_bytes(int slots) { return sizeof(float) * (20 + kRow * slots); }

}  // namespace

// Launches the scan's <adaptive, stratified, split, debug> instantiation
// on `stream`; returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for debug with adaptive or split, which have
// none. Tables, map, budget
// (null without one) and lane counter (one int) are device pointers; the
// caller checks shapes and the shared-memory size. The launch zeroes the
// lane counter on `stream` first, so launches that share one counter must
// share the stream. The cursor and the selection are read with debug
// only.
extern "C" int flat_scan_launch(
    const float* camera, const float* spheres, const int* pixel_map,
    const int* budget, float* out, int* segs, int* next_lane, int adaptive,
    int stratified, int split, int debug, int n, int slots, int g_full,
    int wp, int seed, int sample_offset, int spp, int max_depth,
    int rr_depth, int exhaust_black, int near_zero_guard, float inv_w,
    float inv_h, float cursor_x, float cursor_y, float cursor_z,
    float selected, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.path = path_params(wp, seed, sample_offset, spp, max_depth, rr_depth,
                       exhaust_black, near_zero_guard, inv_w, inv_h);
  p.camera = camera;
  p.spheres = spheres;
  p.pixel_map = pixel_map;
  p.budget = budget;
  p.out = out;
  p.segs = segs;
  p.next_lane = next_lane;
  p.n = n;
  p.slots = slots;
  p.g_full = g_full < slots ? g_full : slots;
  p.dbg = {cursor_x, cursor_y, cursor_z, selected};
  const size_t smem = smem_bytes(slots);
  cudaStream_t st = (cudaStream_t)stream;
  if (debug) {
    if (adaptive || split) return (int)cudaErrorInvalidValue;
    return (int)(stratified ? launch<false, true, false, true>(p, smem, st)
                            : launch<false, false, false, true>(p, smem, st));
  }
  if (adaptive)
    return (int)(stratified ? launch_split<true, true>(p, split, smem, st)
                            : launch_split<true, false>(p, split, smem, st));
  return (int)(stratified ? launch_split<false, true>(p, split, smem, st)
                          : launch_split<false, false>(p, split, smem, st));
}

// The version of flat_scan_launch's argument list, raised whenever it
// changes: a caller binds only a library whose version it knows.
// Version 2 added the lane counter.
extern "C" int flat_scan_abi() { return 2; }

#ifdef RT_FLAT_COUNTERS
// The counter build's totals since the last reset, into `host`
// (kNumCounters entries, then kLiveBins of the live-lane histogram);
// returns the cudaError_t.
extern "C" int flat_scan_counters(unsigned long long* host, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(host, g_counters, sizeof(g_counters));
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(host + kNumCounters, g_live, sizeof(g_live));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zeros[kLiveBins] = {};
  err = cudaMemcpyToSymbol(g_counters, zeros, sizeof(g_counters));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_live, zeros, sizeof(g_live));
}
#endif
