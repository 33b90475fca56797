// The gathered cluster walk on Hopper: one spp chunk for every lane of a
// lane->pixel map.
//
// Replaces the cluster-walk variants of the TPU kernel
// raytracer_tpu/render/pallas_kernel.py `_make_kernel(...).kernel`
// (launched by `_render_chunk_impl`) in its production configuration:
// kd partition with box bounds, one cluster per walk step, packed visit
// key, fused bounce-done test. Three template parameters give its six
// instantiations (each built at two box-mask widths, or as the wide walk
// at kWide, below):
//   kAdaptive   (the TPU kernel's `adaptive=True`): a lane samples up to
//               its own budget (0 = its pixel has converged: the lane does
//               nothing), and two more output rows carry the lane's
//               completed-sample count and its sum of squared sample
//               luminances;
//   kStratified (`sampler='stratified'`): the four camera draws, and on a
//               sample's first bounce the diffuse direction and the glass
//               roll, are the (sample_offset + s)-th point of a Kronecker
//               sequence in 32-bit fixed point under the pixel's hashed
//               rotation. Every other draw stays counter-hashed.
//   kDebug      (`enable_debug`): the overlay of the shared tail (cursor
//               marker, selection outline); the winner's uuid is column
//               10 of its row, the scene index before the partition's
//               reorder (-1 for padding). Debug renders strip the
//               adaptive tolerance, so only <false, s, true> exist.
// All sit in the loop every lane runs, so they are compile-time: the
// <false, false, false> instantiation carries no trace of any.
//
// Design. Each thread runs the TPU kernel's path-regeneration state
// machine for one lane at a time: counters s (sample) and i (bounce),
// walk state (bq, bs, kl) and throughput. The TPU's K-slot virtual
// tiles, r_sub row tiling and 128-lane tile grid existed to balance
// 1024-lane vector tiles and are gone.
//
// What bounds it on this card: issue (the slab tests' min/max, compare
// and select instructions above all) and lanes idle in their warp. What
// the design does about it, each element kept on an A/B on the card
// (PERF.md):
//   - The box test runs once per bounce, and only on the boxes the ray
//     can enter. A bounce's first walk iteration tests one level of
//     parent boxes (each the float32 min/max of kParentFanout
//     consecutive kd leaves) and then only the children of the parents
//     it enters; the boxes it hits go into a bitmask. Later iterations
//     of the bounce re-test only the masked boxes not yet visited: the
//     ray is the same, so their keys are bit-identical. Dropping a missed
//     box changes nothing: its key (>= kFillFloor) could only end the
//     bounce, as the empty selection (INFINITY) does. A missed parent
//     means every child misses: slab bounds round monotonically, so a
//     parent's entry is at most and its exit at least its child's, and
//     the child's three hit conditions imply the parent's.
//   - A lane walks its bounce to the end before the warp runs the tail
//     (Aila and Laine's while-while), so the warp runs the tail once a
//     bounce with its lanes together; the tail (common.cuh) draws the
//     diffuse and metal vectors in one place for the same reason.
//   - One block an SM (1024 threads; the wide walk's 256, below), so one
//     copy of the tables an SM, loaded once; the grid is persistent (as
//     many blocks as fit at once), and a thread whose lane has taken its
//     samples takes the next lane of the map (a warp-aggregated atomic on
//     a counter): lanes stay busy until the map runs out, in the map's
//     cost-descending
//     order. The grid's first lanes go out a warp's 32 at a time to the
//     blocks in turn, so every SM starts on the map's head: its costliest
//     lanes, and after an adaptive re-plan the only lanes with budget.
//   - Boxes are 8 floats and members have an odd stride of float4 rows
//     between clusters (render/tables.py `walk_layout`): two 16-byte
//     loads a box, one a member, and lanes of a warp that visit
//     different clusters read different banks.
//   - A narrow adaptive launch deals one-sample items (lane, sample),
//     where a wide one deals whole lanes. After a re-plan only the hard
//     pixels have budget (glass, crevices, paths of tens of bounces at
//     rr0); as whole lanes each ran its chunk's samples one after another
//     on one thread of a near-empty SM, and the launch lasted as long as
//     its slowest lane's chain. As items they spread over the whole grid.
//     The grain follows the input: items where every live lane's samples
//     fit the item scratch (the launch's item_cap), whole lanes otherwise.
//     An item
//     keeps its sample's sums in the scratch; the one that completes its
//     lane adds them in sample order, so every output stays bit for bit
//     that of whole lanes. The live extent (one past the last lane with
//     budget, and the largest budget) is worked out on the device before
//     the launch; lanes past it are not dealt.
//   - Registers, capped at 64 by the block size, spill: the box mask
//     takes one word up to 32 clusters (a template parameter the
//     launcher picks), and what only the tail reads is formed after the
//     walk.
//
// The wide walk (kWords = kWide), built with -DRT_WALK_WIDE into a library
// of its own, takes partitions of 129 to 512 clusters, as the flat scan
// takes no scene of more than 1022 slots. Its tables pass shared memory
// (the 7,382 slots of the SPD sphereflake, 462 clusters: 470 KB), so:
//   - only the hit-test tables sit in shared memory (camera, globals,
//     boxes and members); a bounce reads its winner row once, from global
//     memory (L2), when it completes;
//   - the visit key holds the cluster index in its 9 low mantissa bits;
//   - the boxes form a 4-ary tree over the kd leaves up to the root:
//     parents and grandparents in shared memory, the levels past them
//     (a third, a fourth of one or two boxes, the root) after the
//     winner rows in global memory;
//   - a bounce walks the tree nearest first. Each thread keeps a short
//     list of pending entries in its shared-memory words (word w of
//     thread t at w * kWalkThreads + t), in order of their packed keys,
//     the nearest last. The bounce starts with the fourth level's boxes,
//     the third-level ones under those it enters, and puts the hit
//     grandparents under those into the list (nearly every ray that
//     meets the scene enters the top levels); then it takes the nearest
//     entry until one's floored key is at or beyond the best: a box's hit
//     children go into the list, a kd leaf is visited. A box's four
//     children are tested together and their hits merged into the list
//     in one pass. A key is slab-tested once, when its box goes in,
//     and kept. A box's entry is never past its children's (the
//     monotone rounding above), so the leaves come off in ascending key
//     order, the flat walk's visits and order; a box is keyed one bucket
//     (512 ulps) below its entry, so at an equal floored entry it comes
//     off before any leaf, and a leaf under it with a smaller cluster
//     index before a leaf already listed;
//   - a warp's 32 lanes start every bounce together (a lane without work
//     stays as a helper until none of the warp has any) and walk it in
//     trips: each lane expands boxes until its nearest entry is a leaf
//     (or its bounce is done), then the lanes with a leaf visit together
//     (Aila and Laine's while-while again), and the trips end when none
//     visits. Where at most kPoolMax lanes visit, the warp's other lanes
//     take part in their member tests (pool_visit: an H100 at 700 W ran
//     the sphereflake's 29-spp launch in 46.9 ms with the trips alone,
//     45.4 with the pool, 55.1-55.6 as lanes that left the loop one by
//     one);
//   - a bounce whose list would pass its capacity (the mask's words and
//     every word a thread's share of the block's shared memory leaves:
//     85 on the sphereflake) starts over as the sweep that came before
//     the list, in the same words used as a mask of hit boxes: every
//     grandparent, the parents under those entered, their children,
//     then the hit ones re-tested each iteration (an H100 at 700 W ran
//     the sphereflake's 29-spp launch in 77.3 ms that way, 70.2 slab
//     tests a bounce); so the walk is exact for any scene;
//   - a block of 256 threads, not 1024: 80 registers a thread, and
//     fewer warps to an SM, whose lanes stay together more (the SIMT of
//     the tail rose 0.52 → 0.88; the sweep ran faster so too);
//   - it counts its lanes' walk iterations, completed bounces and
//     bounces that swept into the launch's counts (one atomic a block,
//     and one shared-memory atomic a sweep).
// Its selection, visit order, tie rule and every output are those of the
// flat walk with 9-bit keys, which its plain version runs.
// The walk-iteration count (the cost row), the segments and every sum
// are bit for bit those of the flat walk that tests every box every
// iteration, one iteration a loop trip: a bounce of v visits makes
// max(1, v) iterations there, and the wide walk counts that.
//
// The motion walk, built with -DRT_WALK_MOTION into a library of its own,
// is the narrow walk's <false, s, false, words> (fixed spp, both
// samplers) for scenes with a shutter: spheres that move linearly from
// c0 at time 0 to c1 at time 1, and the checker material. Its tables
// (render/tables.py `motion_tables`) hold a global or a member as two
// float4, [c0 xyz, r^2, c1 - c0 xyz, 0], and a winner row of 17 floats,
// the static row's 11, then c1 - c0 and the checker's odd colour; its
// boxes bound each sphere's swept volume. So:
//   - each camera ray draws its time t in [0, 1): draw 0 of counter
//     kShutterCtr + its absolute sample index, apart from every counter
//     and rotation the other draws use;
//   - a global or member test forms the centre at t, c0 + t (c1 - c0),
//     and k1 = |c|^2 - r^2 from it (moving_q); the winner's normal takes
//     the centre at t too;
//   - a checker winner scatters as diffuse, with its odd colour where
//     sin(10x) sin(10y) sin(10z) < 0 at the hit point, else its even one
//     (motion_winner);
//   - it counts its member tests and completed bounces in registers, and
//     adds them to the launch's counts once a warp, when the warp's lanes
//     leave the walk.
// A static sphere (c1 = c0) is tested as the narrow walk tests it, bit
// for bit. The narrow and the wide walk's builds hold none of this code.
//
// The RNG, ray generation and the bounce tail live in common.cuh, shared
// with the flat scan (flat_scan.cu). Numerics follow the plain PyTorch
// version (raytracer_tpu_torch/render/cluster_walk.py) operation for
// operation: build with -fmad=false and without --use_fast_math.
// Constants are the float32 roundings of the JAX package's Python
// doubles, as hex literals.

#include <algorithm>

#include "common.cuh"

#if defined(RT_WALK_WIDE) && defined(RT_WALK_MOTION)
#error "the motion walk is the narrow walk's: build it without RT_WALK_WIDE"
#endif

namespace {

using namespace rt;

// one block an SM: one copy of the tables an SM. The narrow walk's block
// of 1024 threads keeps ptxas within 64 registers a thread (32 warps an
// SM). The wide walk's is a quarter of that, at 80 registers a thread:
// an H100 at 700 W ran the sphereflake's 29-spp launch in 55.2 ms at 256
// threads, 56.2 at 192, 57.5 at 320, 67.4 at 1024 (its sweep 65.2 at
// 256, 77.5 at 1024)
#ifdef RT_WALK_WIDE
constexpr int kWalkThreads = 256;
#else
constexpr int kWalkThreads = 1024;
#endif
constexpr int kParentFanout = 4;  // kd leaves per parent box
constexpr int kBoxFloats = 8;     // [lo xyz, 0, hi xyz, 0]
constexpr int kMaxWords = 4;      // MAX_CLUSTERS = 128 bits of box mask
// the wide walk's kWords: its box mask in shared memory, up to
// kWideMaxWords words (MAX_WIDE_CLUSTERS = 512), and its 9 key bits
constexpr int kWide = 0;
constexpr int kWideMaxWords = 16;
constexpr int kWideKeyBits = 9;
// the wide walk's shared memory after its tables: its four counts (two
// adaptive sample counts, walk iterations, bounces) around the adaptive
// deal and its block's count of sweeps, 48 bytes, then the masks
constexpr int kWideExtraBytes = 48;
// the shared memory a block may opt in to (227 KiB on the H100): the wide
// walk's lists take what its tables, counts and masks leave of it
constexpr int kMaxWalkSmemBytes = 232448;
// The wide walk pools a trip's visits across the warp (pool_visit) where
// at most kPoolMax of its lanes visit and a cluster holds at most 32
// members; else each visiting lane tests its cluster's members itself.
// Both give the same bits, so this is placement alone: on the
// sphereflake's 29-spp launch (an H100 at 700 W) the pool gains at 4 to 12
// visiting lanes and loses from 16, its rounds of one member test each
// costing about three of the member loop's; a test build sets it with
// -DRT_WALK_POOL_MAX.
#ifdef RT_WALK_POOL_MAX
constexpr int kPoolMax = RT_WALK_POOL_MAX;
#else
constexpr int kPoolMax = 8;
#endif
// A list entry of the wide walk is a packed key: a kd leaf's is its
// entry's bits floored to a bucket | cluster, as the flat walk's; a box's
// carries kListBox and its index among the listed levels (parents from
// 0, then grandparents) in a bucket one below its entry's. Entries order
// by their bits without kListBox.
constexpr uint32_t kListBox = 0x80000000u;
constexpr uint32_t kBucket = 1u << kWideKeyBits;
constexpr uint32_t kOrderFloor = ~kListBox & ~(kBucket - 1u);
// An item's record in the scratch: r, g, b, sum of lum^2, walk
// iterations, bounces. A lane's sums form only after its last sample, so
// every item of a launch is kept until then. The scratch's capacity in
// items is the launch's item_cap, which the wrapper sizes the scratch by
// (render/cluster_walk.py ITEM_CAP: 2^22 items, 96 MiB, and 16 MiB of
// per-lane counts; it holds every re-plan of the cover's adaptive render,
// 1.5 M items at most at tolerance 0.2, with room for wider ones, and its
// 4-spp profile launch, 3.84 M; a full 31-spp launch, 29.8 M, deals whole
// lanes). A launch whose scratch has other rows is refused.
constexpr int kItemRows = 6;

struct Params {
  PathParams path;
  // the tables as shared memory holds them (render/tables.py
  // `pack_walk`), n_floats, offsets in floats: camera (19) at 0, globals
  // (n_global, 4), parents (n_parents, 8), boxes (k, 8), members (k,
  // mstride, 4), winner (slots, 11) [c xyz, 1/r, mat, albedo rgb, fuzz,
  // ior, uuid]
  const float* tables;
  const int* pixel_map;  // (n, 2) [px, py]
  const int* budget;     // (n,) samples per lane, or null: spp for every lane
  float* out;            // (4, n) rgb sums and walk iterations, lane order;
                         // (6, n) with sample count and sum of lum^2
  int* segs;             // (n,) completed bounces
  int* next_lane;        // work taken past the grid's own, zeroed by the
                         // launch on its stream
  // kAdaptive: the live extent [one past the last lane with budget, the
  // largest budget] (null without a budget: [n, spp]); the item scratch,
  // (kItemRows, item_cap): r, g, b, sum of lum^2, walk iterations,
  // bounces (as int bits) of each item's sample; each lane's count of its
  // items done (item_cap, zero between launches); the launch's counts of
  // the samples run as items and of all samples (null: not counted); the
  // motion walk's counts of member tests and completed bounces
  const int* extent;
  float* items;
  int* lane_items;
  unsigned long long* samples;
  int item_cap;
  int n, n_global, k, group, n_parents, mstride;
  int off_glob, off_par, off_box, off_mem, off_win, n_floats;
  DebugUniforms dbg;     // kDebug: cursor point and selection
  // the wide walk: grandparent boxes (after the parents at off_par), and
  // mask words a thread; its n_floats is off_win, the part in shared
  // memory, and its counts are five. The third and fourth levels' boxes
  // (then the root's), from off_top in global memory; the list's
  // capacity in words a thread.
  int n_grand, n_words;
  int n_l3, n_l4, off_top, list_cap;
};

// Counters of the walk's structure, compiled in only with
// -DRT_WALK_COUNTERS (raytracer_tpu_torch/scripts/walk_ab.py builds it;
// the main path's build never does). Where a warp's active lanes pass,
// the lowest counts the warp; every lane counts itself.
enum WalkCounter {
  kWarpTrips,      // walk iterations of a warp
  kLaneTrips,      // walk iterations of a lane (the cost row's sum)
  kWarpFresh,      // warp iterations where some lane starts a bounce
  kLaneFresh,      // lane iterations that start a bounce
  kWarpVisit,      // warp iterations that run the member loop
  kLaneVisit,      // lane iterations that visit a cluster
  kWarpTail,       // warp runs of the bounce tail
  kLaneTail,       // lane runs of the bounce tail (completed bounces)
  kSlabTests,      // boxes slab-tested, parents included
  // the wide walk's list, where a trip is a pass of its loop (a visit, or
  // the pass that ends the bounce) and kLaneTrips its cost row's
  kLanePasses,     // passes of a lane
  kWarpExpand,     // boxes expanded: warp steps where some lane expands
  kLaneExpand,     // boxes a lane expanded
  kListInserts,    // entries put into the list
  kListMoves,      // entries moved to make room
  kListPeak,       // the bounces' high-water marks, summed
  kListPeakMax,    // the highest high-water mark (an atomicMax)
  kSweeps,         // bounces whose list overflowed, swept instead
  kWarpPooled,     // visit steps of a warp run pooled (pool_visit)
  kPoolRounds,     // their rounds
  // the wide walk's lane cycles (clock64) by phase, each lane charging
  // the cycles since its last mark: the bounce's start (globals and the
  // levels past the grandparents), the expansions up to a trip's visit,
  // the visits, the wait after its list is done for the warp's other
  // lanes, the sweep, and the rest (the tail, the next work's setup)
  kCycTop, kCycExpand, kCycVisit, kCycWait, kCycSweep, kCycTail,
  kNumCounters
};

#ifdef RT_WALK_COUNTERS
__device__ unsigned long long g_counters[kNumCounters];
#define RT_COUNT(c, v) (cnt[c] += (v))
#define RT_WARP_COUNT(c, pred)                                         \
  do {                                                                 \
    const unsigned any_ = __ballot_sync(act_, (pred));                 \
    cnt[c] += (leader_ && any_ != 0u) ? 1u : 0u;                       \
  } while (0)
#define RT_PHASE(c)                                                    \
  do {                                                                 \
    const long long now_ = clock64();                                  \
    cnt[idle ? (int)kCycWait : (int)(c)] +=                            \
        (unsigned long long)(now_ - mark_);                            \
    mark_ = now_;                                                      \
  } while (0)
#else
#define RT_COUNT(c, v) ((void)0)
#define RT_WARP_COUNT(c, pred) ((void)0)
#define RT_PHASE(c) ((void)0)
#endif

#if defined(RT_WALK_MOTION) || defined(RT_WALK_WIDE)
// A 32-bit count summed over the warp's active lanes, exactly, as two
// 16-bit halves.
__device__ __forceinline__ unsigned long long warp_sum(unsigned act,
                                                       uint32_t v) {
  return (unsigned long long)__reduce_add_sync(act, v & 0xFFFFu) +
         ((unsigned long long)__reduce_add_sync(act, v >> 16) << 16);
}
#endif

#ifdef RT_WALK_MOTION
// a sample's time is draw 0 of counter kShutterCtr + its absolute index:
// past every sample's block of counters while they stay below 2^31, and
// apart from the stratified rotations (0xFFFFFFF8 and up)
constexpr uint32_t kShutterCtr = 0x80000000u;
constexpr float kChecker = 0x1.8p+1f;  // 3: the checker's material code
constexpr int kMotionRow = 8;     // floats of a global or member row
constexpr int kMotionWinner = 17; // floats of a winner row

__device__ __forceinline__ float shutter_time(uint32_t pix, uint32_t s_abs) {
  return u01(pix, kShutterCtr + s_abs, 0);
}

// exact_q of the sphere row [c0 xyz, r^2, c1 - c0 xyz, 0] at time tm: the
// centre c0 + tm (c1 - c0), and k1 = |c|^2 - r^2
__device__ __forceinline__ float moving_q(const float* row, float tm,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a, float o_dot_d,
                                          float o_dot_o, float min_t_a) {
  const float4 c0 = *reinterpret_cast<const float4*>(row);
  const float4 mv = *reinterpret_cast<const float4*>(row + 4);
  const float cx = c0.x + tm * mv.x, cy = c0.y + tm * mv.y,
              cz = c0.z + tm * mv.z;
  const float c[4] = {cx, cy, cz, dot3(cx, cy, cz, cx, cy, cz) - c0.w};
  return exact_q(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, min_t_a);
}

// The tail's winner from the motion walk's row w at time tm: wc the
// centre c0 + tm (c1 - c0), wm [1/r, mat, albedo rgb, fuzz, ior]; a
// checker hit scatters as diffuse (mat 0) with the colour at the hit
// point the tail forms, o + (bq / |d|^2) d.
__device__ __forceinline__ void motion_winner(const float* w, float tm,
                                              float bq, float inv_a,
                                              const Path& path, float* wc,
                                              float* wm) {
  wc[0] = w[0] + tm * w[11];
  wc[1] = w[1] + tm * w[12];
  wc[2] = w[2] + tm * w[13];
  for (int j = 0; j < 7; ++j) wm[j] = w[3 + j];
  const float best_t = bq * inv_a;
  if (w[4] > kChecker - 0.5f && w[4] < kChecker + 0.5f && best_t < kQCut) {
    const float hx = path.ox + best_t * path.dx;
    const float hy = path.oy + best_t * path.dy;
    const float hz = path.oz + best_t * path.dz;
    wm[1] = 0.0f;
    if (sinf(10.0f * hx) * sinf(10.0f * hy) * sinf(10.0f * hz) < 0.0f) {
      wm[2] = w[14];
      wm[3] = w[15];
      wm[4] = w[16];
    }
  }
}

// The lanes leaving the walk add their member tests and completed bounces
// to the launch's counts (the motion walk's, where the adaptive walk has
// its sample counts): one atomic each for the lanes that leave together.
__device__ __forceinline__ void add_motion_counts(const Params& p,
                                                  uint32_t tests,
                                                  uint32_t bounces) {
  unsigned long long* counts = p.samples;
  const unsigned act = __activemask();
  const unsigned long long t = warp_sum(act, tests);
  const unsigned long long b = warp_sum(act, bounces);
  if ((int)(threadIdx.x & 31) == __ffs(act) - 1) {
    atomicAdd(&counts[0], t);
    atomicAdd(&counts[1], b);
  }
}
#endif

// the low bits of a packed key that hold the cluster index: 7, or 9 in
// the wide walk
template <int kWords>
constexpr int kKeyMask = kWords == kWide ? (1 << kWideKeyBits) - 1 : 127;

template <int kWords>
__device__ __forceinline__ float key_floor(float key) {
  return __int_as_float(__float_as_int(key) & ~kKeyMask<kWords>);
}

// direction reciprocal clamped away from zero: no slab product reaches inf
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d >= 0.0f ? fmaxf(d, kUEps) : fminf(d, -kUEps));
}

// Slab test of the box [lo xyz, 0, hi xyz, 0] at `b` in q-space: the
// entry q where the ray enters it, kFillQ where it misses.
__device__ __forceinline__ float box_entry(const float* b, float ox,
                                           float oy, float oz, float ivx,
                                           float ivy, float ivz, float a,
                                           float min_t_a) {
  const float4 lo = *reinterpret_cast<const float4*>(b);
  const float4 hi = *reinterpret_cast<const float4*>(b + 4);
  float t1 = (lo.x - ox) * ivx, t2 = (hi.x - ox) * ivx;
  float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
  t1 = (lo.y - oy) * ivy;
  t2 = (hi.y - oy) * ivy;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  t1 = (lo.z - oz) * ivz;
  t2 = (hi.z - oz) * ivz;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  const float qn = fmaxf(tn * a, min_t_a);
  const bool hitb = (tf >= tn) & (tf * a >= min_t_a) & (qn < kQCut);
  return hitb ? qn : kFillQ;
}

// A set of boxes, one bit a box, in kWords registers: every word is
// named by a constant after unrolling, so none goes to local memory.
// Partitions of at most 32 clusters take one word (the launcher picks),
// which keeps six registers free under the 64-register cap.
template <int kWords>
struct BoxMask {
  uint32_t w[kWords];
};

template <int kWords>
__device__ __forceinline__ void mask_or(BoxMask<kWords>& m, int word,
                                        uint32_t bits) {
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    if (j == word) m.w[j] |= bits;
}

template <int kWords>
__device__ __forceinline__ void mask_clear(BoxMask<kWords>& m, int c) {
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    if (j == (c >> 5)) m.w[j] &= ~(1u << (c & 31));
}

// Copy the packed tables into shared memory, once per block.
__device__ __forceinline__ void load_tables(float* smem, const float* src,
                                            int n_floats) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(smem);
  for (int j = threadIdx.x; j < n_floats / 4; j += blockDim.x) d4[j] = s4[j];
  __syncthreads();
}

// Work items (kAdaptive). The grid deals work indices w from its counter
// (first_lane, next_lane). Where every live lane's items fit the scratch
// (live end x largest budget <= item_cap), w is an item: sample
// s = w % stride of lane j = w / stride; else w is a whole lane, as in
// the other instantiations. Lanes past the live end have no budget:
// none is dealt, and the blocks store their zeros as they finish. Thread
// 0 of each block plans the deal from the live extent before the
// tables' barrier; it sits in shared memory after the tables, beside the
// block's counts of the samples it ran as items and in whole lanes.
struct Deal {
  int n_work;    // work indices dealt in all
  int stride;    // items a lane holds (its largest budget), 0: whole lanes
  int live_end;  // one past the last lane with budget
};
enum SampleCount { kItemSamples, kLaneSamples };
// after the tables: the two sample counts (16 bytes), then the deal; the
// wide walk's count of sweeps after the deal (at 28 bytes, 32 bits),
// its iteration and bounce counts at 32 bytes (its block's counts 4 and
// 5); they go to the launch's counts 4, 2 and 3. Its visits and those the
// pool served go to the launch's 5 and 6 from each warp (add_visits).
constexpr int kAdaptiveSmemBytes = 32;
enum WalkCount {
  kWalkIterations = 2, kWalkSegments = 3, kWalkSweeps = 4, kWalkVisits = 5,
  kWalkPooled = 6
};
constexpr int kWalkCountsAt = 2;  // the block's: kWalkIterations + 2

__device__ __forceinline__ unsigned long long* counts_of(const Params& p,
                                                         float* smem) {
  return reinterpret_cast<unsigned long long*>(smem + p.n_floats);
}

__device__ __forceinline__ Deal& deal_of(const Params& p, float* smem) {
  return *reinterpret_cast<Deal*>(smem + p.n_floats + 4);
}

// The wide walk's mask words of this thread, which hold its list: word w
// at w * kWalkThreads.
__device__ __forceinline__ uint32_t* wide_mask(const Params& p,
                                               float* smem) {
  return reinterpret_cast<uint32_t*>(smem + p.n_floats +
                                     kWideExtraBytes / 4) +
         threadIdx.x;
}

// The wide walk's block count of bounces that swept, after the deal.
__device__ __forceinline__ uint32_t* sweeps_of(const Params& p, float* smem) {
  return reinterpret_cast<uint32_t*>(smem + p.n_floats + 7);
}

// The wide walk's fresh bounce: the grandparents the ray enters, under
// each the parents it enters, under each of those the children (kd
// leaves) it hits. A missed box's children all miss (see the parents
// above), so these are the boxes the flat walk's first iteration hits:
// they go into the mask, and m0, m1 get the two nearest keys of them.
// Each lane loops over its own hits, so a warp makes as many trips as
// its busiest lane, not as the union of its lanes' hits. A word outside
// `live` is never read: the bounce's first hit in it assigns it. Returns
// the boxes it tested.
__device__ __forceinline__ int wide_fresh(const Params& p,
                                          const float* s_par,
                                          const float* s_box,
                                          uint32_t* mask, uint32_t& live,
                                          float ox, float oy, float oz,
                                          float ivx, float ivy, float ivz,
                                          float a, float min_t_a, float& m0,
                                          float& m1) {
  live = 0u;
  const float* s_grand = s_par + kBoxFloats * p.n_parents;
  uint32_t grand = 0u;
  for (int g = 0; g < p.n_grand; ++g) {
    if (box_entry(s_grand + kBoxFloats * g, ox, oy, oz, ivx, ivy, ivz, a,
                  min_t_a) < kFillQ)
      grand |= 1u << g;
  }
  int tested = p.n_grand;
  for (; grand != 0u; grand &= grand - 1u) {
    const int q0 = kParentFanout * (__ffs(grand) - 1);
    const int nq = min(kParentFanout, p.n_parents - q0);
    uint32_t par = 0u;
    for (int j = 0; j < nq; ++j) {
      if (box_entry(s_par + kBoxFloats * (q0 + j), ox, oy, oz, ivx, ivy,
                    ivz, a, min_t_a) < kFillQ)
        par |= 1u << j;
    }
    tested += nq;
    for (; par != 0u; par &= par - 1u) {
      const int c0 = kParentFanout * (q0 + __ffs(par) - 1);
      const int nc = min(kParentFanout, p.k - c0);
      uint32_t run = 0u;
      for (int c = c0; c < c0 + nc; ++c) {
        const float qe = box_entry(s_box + kBoxFloats * c, ox, oy, oz, ivx,
                                   ivy, ivz, a, min_t_a);
        if (qe < kFillQ) {
          run |= 1u << (c & 31);
          const float key = __int_as_float(
              (__float_as_int(qe) & ~kKeyMask<kWide>) | c);
          if (key < m0) {
            m1 = m0;
            m0 = key;
          } else if (key < m1) {
            m1 = key;
          }
        }
      }
      tested += nc;
      if (run != 0u) {
        // a run of kParentFanout children lies in one word
        const uint32_t word = 1u << (c0 >> 5);
        uint32_t& m = mask[(c0 >> 5) * kWalkThreads];
        m = (live & word) != 0u ? m | run : run;
        live |= word;
      }
    }
  }
  return tested;
}

// The wide walk's slab test of its masked boxes: a missed one leaves the
// mask, and m0, m1 get the two nearest keys of the hit ones. Returns the
// boxes it tested.
__device__ __forceinline__ int wide_test(const float* s_box, uint32_t* mask,
                                          uint32_t& live, float ox,
                                          float oy, float oz, float ivx,
                                          float ivy, float ivz, float a,
                                          float min_t_a, float& m0,
                                          float& m1) {
  int tested = 0;
  for (uint32_t lw = live; lw != 0u; lw &= lw - 1u) {
    const int j = __ffs(lw) - 1;
    uint32_t bits = mask[j * kWalkThreads], kept = 0u;
    while (bits != 0u) {
      const int c = 32 * j + __ffs(bits) - 1;
      bits &= bits - 1u;
      ++tested;
      const float qe = box_entry(s_box + kBoxFloats * c, ox, oy, oz, ivx,
                                 ivy, ivz, a, min_t_a);
      if (qe < kFillQ) {
        kept |= 1u << (c & 31);
        const float key = __int_as_float(
            (__float_as_int(qe) & ~kKeyMask<kWide>) | c);
        if (key < m0) {
          m1 = m0;
          m0 = key;
        } else if (key < m1) {
          m1 = key;
        }
      }
    }
    mask[j * kWalkThreads] = kept;
    if (kept == 0u) live &= ~(1u << j);
  }
  return tested;
}

// The best of the exact global tests, which a wide bounce starts from
// (the narrow walk's loop keeps its own copies of this and of
// visit_cluster, so that its code stays the base's instruction for
// instruction).
__device__ __forceinline__ void global_best(const Params& p,
                                            const float* s_glob, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float a,
                                            float o_dot_d, float o_dot_o,
                                            float min_t_a, float& bq,
                                            int& bs) {
  float g_best = kFillQ;
  int g_slot = 0;
  for (int g = 0; g < p.n_global; ++g) {
    float q = exact_q(s_glob + 4 * g, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                      o_dot_o, min_t_a);
    if (q < g_best) {
      g_best = q;
      g_slot = g;
    }
  }
  bq = g_best;
  bs = g_slot;
}

// The exact tests of cluster cidx's members against the best hit.
__device__ __forceinline__ void visit_cluster(const Params& p,
                                              const float* s_mem, int cidx,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float a, float o_dot_d,
                                              float o_dot_o, float min_t_a,
                                              float& bq, int& bs) {
  const float4* mb =
      reinterpret_cast<const float4*>(s_mem + 4 * cidx * p.mstride);
  for (int m = 0; m < p.group; ++m) {
    const float4 c4 = mb[m];
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    float q =
        exact_q(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, min_t_a);
    if (q < bq) {
      bq = q;
      bs = p.n_global + cidx * p.group + m;
    }
  }
}

// A trip's visits pooled across the warp: each lane of `vis` visits its
// cluster cidx. The clusters' member tests are dealt over the warp's 32
// lanes in rounds, in slots of 2^shift lanes (16, or 32 for a group past
// 16), one visiting lane a slot: in round r, lane h·2^shift + m tests
// member m of the cluster of the (r·(32 >> shift) + h)-th lowest visiting
// lane, with that lane's ray, taken by shuffles (a lane past the group
// tests a member too, and drops its q). Each slot's least q comes from a
// whole-warp reduction (one over part of the warp runs as a loop), and a
// ballot of the lanes that hold their slot's least gives the least member
// among equal q: the slot's first such lane. The visiting lane applies
// that once with the member loop's strict <: the serial loop over the
// members in order (visit_cluster) gives that same bq and bs, ties
// included. q lies in (0, kFillQ] (a ray whose min_t_a could make it 0
// sweeps), so its bits order as its value. Every lane of the warp takes
// part; a lane without a visit helps.
__device__ __forceinline__ void pool_visit(const Params& p,
                                           const float* s_mem,
                                           unsigned vis, int shift,
                                           bool leaf, int cidx, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float a,
                                           float o_dot_d, float o_dot_o,
                                           float min_t_a, float& bq,
                                           int& bs) {
  const int lane = (int)(threadIdx.x & 31);
  const int per = 32 >> shift;  // visiting lanes a round: 2 or 1
  const int slot = lane >> shift, m = lane & ((1 << shift) - 1);
  const int mm = min(m, p.group - 1);  // the member this lane reads
  // this lane's round and slot as a visitor: its rank among them
  const int rank = __popc(vis & ((1u << lane) - 1u));
  const int my_round = rank >> (5 - shift), my_slot = rank & (per - 1);
  uint32_t gq = 0u, gm = 0u;  // its slot's least, as a visitor
  unsigned left = vis;
  for (int r = 0; left != 0u; ++r) {
    // the visiting lane this slot serves: the slot-th lowest one left
    const unsigned l1 = left & (left - 1u);
    const unsigned o = slot != 0 ? l1 : left;
    left = per == 2 ? l1 & (l1 - 1u) : l1;
    const int src = o != 0u ? __ffs(o) - 1 : lane;
    const float rox = __shfl_sync(~0u, ox, src);
    const float roy = __shfl_sync(~0u, oy, src);
    const float roz = __shfl_sync(~0u, oz, src);
    const float rdx = __shfl_sync(~0u, dx, src);
    const float rdy = __shfl_sync(~0u, dy, src);
    const float rdz = __shfl_sync(~0u, dz, src);
    const float ra = __shfl_sync(~0u, a, src);
    const float rod = __shfl_sync(~0u, o_dot_d, src);
    const float roo = __shfl_sync(~0u, o_dot_o, src);
    const float rmin = __shfl_sync(~0u, min_t_a, src);
    const int rc = __shfl_sync(~0u, cidx, src);
    const float4 c4 =
        reinterpret_cast<const float4*>(s_mem + 4 * rc * p.mstride)[mm];
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    const float q =
        exact_q(c, rox, roy, roz, rdx, rdy, rdz, ra, rod, roo, rmin);
    const uint32_t key =
        o != 0u && m < p.group ? (uint32_t)__float_as_int(q) : ~0u;
    // each slot's least q, then the lanes that hold their slot's: the
    // first of them in a slot holds its least member
    const uint32_t least0 = __reduce_min_sync(~0u, slot == 0 ? key : ~0u);
    const uint32_t least1 =
        per == 2 ? __reduce_min_sync(~0u, slot != 0 ? key : ~0u) : ~0u;
    const unsigned at =
        __ballot_sync(~0u, key == (slot == 0 ? least0 : least1));
    if (my_round == r) {
      gq = my_slot == 0 ? least0 : least1;
      gm = (uint32_t)__ffs(my_slot == 0 ? at : at >> 16) - 1u;
    }
  }
  if (leaf) {
    const float q = __int_as_float((int)gq);
    if (q < bq) {
      bq = q;
      bs = p.n_global + cidx * p.group + (int)gm;
    }
  }
}

// The list entry of a hit box (a kd leaf, or with `box` a box of a listed
// level) of index id, entered at qe.
__device__ __forceinline__ uint32_t list_entry(float qe, int id, bool box) {
  const uint32_t b = (uint32_t)__float_as_int(qe) & ~(kBucket - 1u);
  return box ? kListBox | (b - kBucket) | (uint32_t)id : b | (uint32_t)id;
}

// An entry's order: its key without kListBox.
__device__ __forceinline__ uint32_t list_order(uint32_t e) {
  return e & ~kListBox;
}

// Tests the run of nc (1 to kParentFanout) boxes from index `first` at
// `rows` (a kd leaf's row, or a listed level's, the index its id), and
// merges the hit ones into the list as entries of kind `box`. The list
// holds len entries in order, the nearest last, and `head`, the nearest,
// in a register too (anything where len is 0); both are updated. The
// four tests are unrolled, so their loads go out together (a run shorter
// than four tests its last box again and drops the result), and the hits,
// sorted in registers, go in with one pass from the list's end: each entry
// nearer than a hit moves up once. false where the list would pass `cap`.
// `tested` and `moved` count the boxes tested and the entries moved.
__device__ __forceinline__ bool expand_run(const float* rows, int first,
                                           int nc, bool box, uint32_t* list,
                                           int& len, uint32_t& head, int cap,
                                           float ox, float oy, float oz,
                                           float ivx, float ivy, float ivz,
                                           float a, float min_t_a,
                                           int& tested, int& moved) {
  tested += nc;
  uint32_t h[kParentFanout];
#pragma unroll
  for (int j = 0; j < kParentFanout; ++j) {
    const int c = first + min(j, nc - 1);
    const float qe = box_entry(rows + kBoxFloats * c, ox, oy, oz, ivx, ivy,
                               ivz, a, min_t_a);
    h[j] = j < nc && qe < kFillQ ? list_entry(qe, c, box) : ~0u;
  }
  // a sorting network, nearest first; the missed (~0u) last. The run's
  // entries are of one kind, so their bits order as their orders do.
  uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], t;
  t = min(h0, h1), h1 = max(h0, h1), h0 = t;
  t = min(h2, h3), h3 = max(h2, h3), h2 = t;
  t = min(h0, h2), h2 = max(h0, h2), h0 = t;
  t = min(h1, h3), h3 = max(h1, h3), h1 = t;
  t = min(h1, h2), h2 = max(h1, h2), h1 = t;
  const int hits = (int)(h0 != ~0u) + (int)(h1 != ~0u) + (int)(h2 != ~0u) +
                   (int)(h3 != ~0u);
  if (hits == 0) return true;
  if (len + hits > cap) return false;
  int i = len - 1;
  uint32_t f = head;  // list[i] while i >= 0
  const uint32_t top =
      i >= 0 && list_order(f) < list_order(h0) ? f : h0;
  for (int w = len + hits - 1, k = 0; k < hits; --w) {
    if (i >= 0 && list_order(f) < list_order(h0)) {
      list[w * kWalkThreads] = f;
      ++moved;
      --i;
      f = i >= 0 ? list[i * kWalkThreads] : 0u;
    } else {
      list[w * kWalkThreads] = h0;
      h0 = h1;
      h1 = h2;
      h2 = h3;
      ++k;
    }
  }
  len += hits;
  head = top;
  return true;
}

// The start of a wide bounce's list: the fourth level's boxes (one or
// two; after the third level's in global memory); under each one the ray
// enters, its third-level children; and under each of those it enters,
// its grandparents, the hit ones into the list. The levels above the
// grandparents are few, and nearly every ray that meets the scene enters
// them, so they are expanded at once rather than through the list.
// false where the list overflowed.
__device__ __forceinline__ bool wide_top(const Params& p, const float* s_par,
                                         uint32_t* list, int& len,
                                         uint32_t& head, float ox, float oy,
                                         float oz, float ivx, float ivy,
                                         float ivz, float a, float min_t_a,
                                         int& tested, int& moved) {
  const float* top = p.tables + p.off_top;
  for (int t = 0; t < p.n_l4; ++t) {
    ++tested;
    if (box_entry(top + kBoxFloats * (p.n_l3 + t), ox, oy, oz, ivx, ivy,
                  ivz, a, min_t_a) >= kFillQ)
      continue;
    const int c0 = kParentFanout * t;
    const int nc = min(kParentFanout, p.n_l3 - c0);
    tested += nc;
    float q[kParentFanout];
#pragma unroll
    for (int j = 0; j < kParentFanout; ++j)
      q[j] = box_entry(top + kBoxFloats * (c0 + min(j, nc - 1)), ox, oy, oz,
                       ivx, ivy, ivz, a, min_t_a);
#pragma unroll
    for (int j = 0; j < kParentFanout; ++j) {
      if (j >= nc || q[j] >= kFillQ) continue;
      // its grandparents, listed after the parents
      const int g0 = kParentFanout * (c0 + j);
      if (!expand_run(s_par, p.n_parents + g0,
                      min(kParentFanout, p.n_grand - g0), true, list, len,
                      head, p.list_cap, ox, oy, oz, ivx, ivy, ivz, a,
                      min_t_a, tested, moved))
        return false;
    }
  }
  return true;
}

// Expands the box entry e, which the list no longer holds: merges its hit
// children into the list. A grandparent's children are parents, a
// parent's kd leaves, all in shared memory. false where the list
// overflowed.
__device__ __forceinline__ bool wide_expand(const Params& p,
                                            const float* s_par,
                                            const float* s_box,
                                            uint32_t* list, int& len,
                                            uint32_t& head, uint32_t e,
                                            float ox, float oy, float oz,
                                            float ivx, float ivy, float ivz,
                                            float a, float min_t_a,
                                            int& tested, int& moved) {
  const int u = (int)(e & (kBucket - 1u));
  const bool leaves = u < p.n_parents;
  const int first = kParentFanout * (leaves ? u : u - p.n_parents);
  const int end = leaves ? p.k : p.n_parents;
  return expand_run(leaves ? s_box : s_par, first,
                    min(kParentFanout, end - first), !leaves, list, len,
                    head, p.list_cap, ox, oy, oz, ivx, ivy, ivz, a, min_t_a,
                    tested, moved);
}

// The sweep a bounce falls back to where its list overflowed, over the
// same words used as a mask: from the globals' best, every box the ray
// crosses (wide_fresh), then nearest first, each later iteration
// re-testing the hit boxes not yet visited (wide_test). Returns its
// visits; `tested` counts the boxes tested.
__device__ __forceinline__ int wide_sweep(const Params& p,
                                          const float* s_glob,
                                          const float* s_par,
                                          const float* s_box,
                                          const float* s_mem,
                                          uint32_t* mask, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float ivx,
                                          float ivy, float ivz, float a,
                                          float o_dot_d, float o_dot_o,
                                          float min_t_a, float& bq, int& bs,
                                          int& tested) {
  global_best(p, s_glob, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o,
              min_t_a, bq, bs);
  uint32_t live;
  float m0 = INFINITY, m1 = INFINITY;
  tested += wide_fresh(p, s_par, s_box, mask, live, ox, oy, oz, ivx, ivy,
                       ivz, a, min_t_a, m0, m1);
  int visits = 0;
  while ((key_floor<kWide>(m0) < bq) & (m0 < kFillFloor)) {
    const int cidx = __float_as_int(m0) & kKeyMask<kWide>;
    visit_cluster(p, s_mem, cidx, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                  o_dot_o, min_t_a, bq, bs);
    mask[(cidx >> 5) * kWalkThreads] &= ~(1u << (cidx & 31));
    ++visits;
    if ((key_floor<kWide>(m1) >= bq) | (m1 >= kFillFloor)) break;
    m0 = m1 = INFINITY;
    tested += wide_test(s_box, mask, live, ox, oy, oz, ivx, ivy, ivz, a,
                        min_t_a, m0, m1);
  }
  return visits;
}

// Thread 0's plan of its block's deal, from the live extent ([n, spp]
// without a budget).
__device__ __forceinline__ void plan_deal(const Params& p, float* smem) {
  unsigned long long* counts = counts_of(p, smem);
  counts[kItemSamples] = counts[kLaneSamples] = 0ull;
  // a budget without its extent: whole lanes, as its largest is unknown
  const int live = p.extent != nullptr ? p.extent[0] : p.n;
  const int stride = p.extent != nullptr ? p.extent[1]
                     : p.budget == nullptr ? p.path.spp
                                           : 0;
  const bool items =
      stride > 0 && (long long)live * stride <= p.item_cap;
  Deal& d = deal_of(p, smem);
  d.stride = items ? stride : 0;
  d.n_work = items ? live * stride : live;
  d.live_end = live;
}

// The work indices a thread may take: the deal's, or every lane of the
// map.
template <bool kAdaptive>
__device__ __forceinline__ int work_end(const Params& p, float* smem) {
  if constexpr (kAdaptive) return deal_of(p, smem).n_work;
  return p.n;
}

// Item t: lane j's setup (lane_setup, which stores the zeros of a lane
// without budget), then sample s, which is the item's only one (limit
// s + 1); an item past its lane's budget has nothing to do.
__device__ __forceinline__ bool item_setup(const Params& p, int stride, int t,
                                           float& px, float& py,
                                           uint32_t& pix, int& limit,
                                           int& s) {
  const int j = t / stride;
  s = t - j * stride;
  if (!lane_setup<true>(p.path, p.pixel_map, p.budget, p.out, p.segs, p.n, j,
                        px, py, pix, limit))
    return false;
  if (s >= limit) return false;
  limit = s + 1;
  return true;
}

// The setup of work index w: an item, or a lane from its first sample.
template <bool kAdaptive>
__device__ __forceinline__ bool take(const Params& p, float* smem, int w,
                                     float& px, float& py, uint32_t& pix,
                                     int& limit, int& s) {
  s = 0;
  if constexpr (kAdaptive) {
    const int stride = deal_of(p, smem).stride;
    if (stride > 0) return item_setup(p, stride, w, px, py, pix, limit, s);
  }
  return lane_setup<kAdaptive>(p.path, p.pixel_map, p.budget, p.out, p.segs,
                               p.n, w, px, py, pix, limit);
}

// Item t has run its sample: its sums, walk iterations and bounces go to
// its column of the scratch, then it counts itself done in its lane. The
// thread that completes the lane adds the lane's columns in sample order
// from zero, as one thread running the lane's samples one after another
// adds them (a sample contributes once, where its path ends; every other
// bounce adds zeros), and writes the lane's rows as write_lane does.
// Walk iterations and bounces are whole numbers, exact in any order.
__device__ __forceinline__ void finish_item(const Params& p, float* smem,
                                            int stride, int t,
                                            const Sums& sums, float cost,
                                            int nsegs) {
  float* it = p.items;
  const int cap = p.item_cap;
  it[t] = sums.r;
  it[cap + t] = sums.g;
  it[2 * cap + t] = sums.b;
  it[3 * cap + t] = sums.l2;
  it[4 * cap + t] = cost;
  it[5 * cap + t] = __int_as_float(nsegs);
  atomicAdd(&counts_of(p, smem)[kItemSamples], 1ull);
  const int j = t / stride;
  const int budget = p.budget != nullptr ? p.budget[j] : p.path.spp;
  __threadfence();  // the column before the count
  if (atomicAdd(&p.lane_items[j], 1) != budget - 1) return;
  __threadfence();
  p.lane_items[j] = 0;  // as every launch finds it
  Sums acc = {0.0f, 0.0f, 0.0f, 0.0f};
  float lane_cost = 0.0f;
  int lane_segs = 0;
  // the other items' columns, read past the SM's L1 (ld.global.cg)
  for (int q = j * stride, end = q + budget; q < end; ++q) {
    acc.r = acc.r + __ldcg(it + q);
    acc.g = acc.g + __ldcg(it + cap + q);
    acc.b = acc.b + __ldcg(it + 2 * cap + q);
    acc.l2 = acc.l2 + __ldcg(it + 3 * cap + q);
    lane_cost = lane_cost + __ldcg(it + 4 * cap + q);
    lane_segs += __float_as_int(__ldcg(it + 5 * cap + q));
  }
  const int n = p.n;
  p.out[j] = acc.r;
  p.out[n + j] = acc.g;
  p.out[2 * n + j] = acc.b;
  p.out[3 * n + j] = lane_cost;
  p.out[4 * n + j] = (float)budget;  // every sample completed
  p.out[5 * n + j] = acc.l2;
  p.segs[j] = lane_segs;
}

// Work index w is done: an item's column, or a lane's rows.
template <bool kAdaptive>
__device__ __forceinline__ void finish(const Params& p, float* smem, int w,
                                       const Sums& sums, float cost,
                                       const Path& path, int segs) {
  if constexpr (kAdaptive) {
    const int stride = deal_of(p, smem).stride;
    if (stride > 0) {
      finish_item(p, smem, stride, w, sums, cost, segs);
      return;
    }
    atomicAdd(&counts_of(p, smem)[kLaneSamples],
              (unsigned long long)path.s);
  }
  write_lane<kAdaptive>(p.out, p.segs, p.n, w, sums, cost, path, segs);
}

// The end of an adaptive block: the zeros of its share of the lanes past
// the live end, then its sample counts into the launch's (one atomic each).
__device__ __forceinline__ void end_block(const Params& p, float* smem) {
  const int stride = (int)(gridDim.x * blockDim.x);
  for (int j = deal_of(p, smem).live_end +
               (int)(blockIdx.x * blockDim.x + threadIdx.x);
       j < p.n; j += stride) {
    for (int c = 0; c < 6; ++c) p.out[c * p.n + j] = 0.0f;
    p.segs[j] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0 && p.samples != nullptr) {
    const unsigned long long* c = counts_of(p, smem);
    atomicAdd(&p.samples[0], c[kItemSamples]);
    atomicAdd(&p.samples[1], c[kItemSamples] + c[kLaneSamples]);
  }
}

// The wide walk's count of a finished work index's walk iterations and
// bounces, into its block's.
__device__ __forceinline__ void count_walk(const Params& p, float* smem,
                                           float cost, int segs) {
  unsigned long long* counts = counts_of(p, smem) + kWalkCountsAt;
  atomicAdd(&counts[kWalkIterations], (unsigned long long)cost);
  atomicAdd(&counts[kWalkSegments], (unsigned long long)segs);
}

#ifdef RT_WALK_WIDE
// The lanes leaving the wide walk add their visits, and those of them the
// pool served, to the launch's counts: one atomic each for the lanes that
// leave together.
__device__ __forceinline__ void add_visits(const Params& p, uint32_t visits,
                                           uint32_t pooled) {
  const unsigned act = __activemask();
  const unsigned long long v = warp_sum(act, visits);
  const unsigned long long q = warp_sum(act, pooled);
  if ((int)(threadIdx.x & 31) == __ffs(act) - 1) {
    atomicAdd(&p.samples[kWalkVisits], v);
    atomicAdd(&p.samples[kWalkPooled], q);
  }
}
#endif

template <bool kAdaptive, bool kStratified, bool kDebug, int kWords>
__device__ __forceinline__ void walk(const Params& p, float* smem) {
  constexpr bool kIsWide = kWords == kWide;
  const float* s_cam = smem;
  const float* s_glob = smem + p.off_glob;
  const float* s_par = smem + p.off_par;
  const float* s_box = smem + p.off_box;
  const float* s_mem = smem + p.off_mem;
  // the winner rows: in shared memory, or the wide walk's in global memory
  const float* s_win = (kIsWide ? p.tables : smem) + p.off_win;
  const uint32_t dps = 4u + (uint32_t)p.path.max_depth * kDrawsPerBounce;

  // the work's pixel, its hash, its first sample and its sample limit;
  // work without budget stores its zeros and the thread takes the next
  int lane = first_lane();
  float px, py;
  uint32_t pix;
  int limit;
  Path path;
  // the wide walk: a thread without work stays as a helper of its warp's
  // others (idle) until every lane of the warp has none
  [[maybe_unused]] bool idle = false;
  for (;;) {
    if (lane >= work_end<kAdaptive>(p, smem)) {
      if constexpr (!kIsWide) return;
      idle = true;
      px = py = 0.0f;
      pix = 0u;
      limit = path.s = 0;
      break;
    }
    if (take<kAdaptive>(p, smem, lane, px, py, pix, limit, path.s)) break;
    lane = next_lane(p.next_lane);
  }
  path.i = 0;
  gen_ray<kStratified>(s_cam, p.path,
                       (uint32_t)(p.path.sample_offset + path.s), dps, px,
                       py, pix, path);
  path.cr = path.cg = path.cb = 1.0f;
#ifdef RT_WALK_MOTION
  // the sample's time; the member tests and completed bounces to count
  float tm = shutter_time(pix, (uint32_t)(p.path.sample_offset + path.s));
  uint32_t n_tests = 0u, n_bounces = 0u;
#endif
  float bq = kFillQ, kl = kNegBig;  // best q, visited cursor (packed key)
  int bs = 0;                       // winner slot
  // boxes the bounce's ray hits, unvisited, in registers; the wide
  // walk's pending list (or its sweep's mask) in shared memory
  BoxMask<kIsWide ? 1 : kWords> hits = {};
  uint32_t* const mask = kIsWide ? wide_mask(p, smem) : nullptr;
  // the wide walk's pool: whether it takes the partition's clusters, its
  // slots' width (log2: 16 lanes, or 32 for a group past 16), and the
  // lane's visits and those of them the pool served
  [[maybe_unused]] const bool pool = p.group <= 32;
  [[maybe_unused]] const int pool_shift = p.group > 16 ? 5 : 4;
  [[maybe_unused]] uint32_t n_visits = 0u, pooled = 0u;
  Sums sums = {0.0f, 0.0f, 0.0f, 0.0f};
  float cost = 0.0f;
  int segs = 0;
#ifdef RT_WALK_COUNTERS
  unsigned long long cnt[kNumCounters] = {};
  [[maybe_unused]] long long mark_ = kIsWide ? clock64() : 0ll;
#endif

  for (;;) {
    if constexpr (kIsWide) {
      // the warp's lanes start each bounce together, until none has work
      if (__all_sync(~0u, idle)) break;
    }
    const float ox = path.ox, oy = path.oy, oz = path.oz;
    const float dx = path.dx, dy = path.dy, dz = path.dz;
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
    const float o_dot_o = dot3(ox, oy, oz, ox, oy, oz);
    const float min_t_a = kMinT * a;
    const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
    if constexpr (kIsWide) {
      // --- the wide walk's bounce: its clusters nearest first from the
      // pending list, or the sweep where the list overflows ---
      [[maybe_unused]] int tested = 0, moved = 0;
#ifdef RT_WALK_COUNTERS
      {
        const unsigned act_ = __activemask();
        const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1;
        RT_WARP_COUNT(kWarpFresh, !idle);
        RT_COUNT(kLaneFresh, idle ? 0u : 1u);
      }
      int peak = 0;
#endif
      RT_PHASE(kCycTail);
      int len = 0;
      uint32_t head = 0u;  // the list's nearest entry, while len > 0
      bool over = false;
      if (!idle) {
        global_best(p, s_glob, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o,
                    min_t_a, bq, bs);
        // a box keyed a bucket below its entry needs entries past the
        // lowest buckets: a ray whose least entry (min_t_a) lies there, of
        // a degenerate direction, sweeps
        over = (uint32_t)__float_as_int(min_t_a) < 2u * kBucket ||
               !wide_top(p, s_par, mask, len, head, ox, oy, oz, ivx, ivy,
                         ivz, a, min_t_a, tested, moved);
      }
      RT_PHASE(kCycTop);
#ifdef RT_WALK_COUNTERS
      peak = len;
#endif
      int visits = 0;
      // the warp's lanes walk the bounce in trips: each lane expands
      // boxes until its nearest entry is a kd leaf or its bounce is done,
      // then the lanes with a leaf visit it, their member tests pooled
      // across the warp where they are few. A lane whose bounce is done
      // (whose list overflowed, or without work) helps until none visits.
      bool walking = !idle && !over;
      for (;;) {
#ifdef RT_WALK_COUNTERS
        const unsigned act_ = ~0u;
        const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1;
        RT_WARP_COUNT(kWarpTrips, walking);
        RT_COUNT(kLanePasses, walking ? 1u : 0u);
#endif
        bool leaf = false;
        while (walking && len > 0) {
          const uint32_t e = head;
          if (__int_as_float(e & kOrderFloor) >= bq) break;
          if ((e & kListBox) == 0u) {
            leaf = true;
            break;
          }
          --len;
          if (len > 0) head = mask[(len - 1) * kWalkThreads];
#ifdef RT_WALK_COUNTERS
          const int ins_ = len;
          {
            const unsigned act_ = __activemask();
            const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1;
            RT_WARP_COUNT(kWarpExpand, true);
            RT_COUNT(kLaneExpand, 1u);
          }
#endif
          over = !wide_expand(p, s_par, s_box, mask, len, head, e, ox, oy,
                              oz, ivx, ivy, ivz, a, min_t_a, tested, moved);
#ifdef RT_WALK_COUNTERS
          RT_COUNT(kListInserts, (unsigned long long)(len - ins_));
          peak = max(peak, len);
#endif
          if (over) break;
        }
        walking = leaf;
        const unsigned vis = __ballot_sync(~0u, leaf);
        RT_PHASE(kCycExpand);
        if (vis == 0u) break;
        RT_WARP_COUNT(kWarpVisit, leaf);
        RT_COUNT(kLaneVisit, leaf ? 1u : 0u);
        int cidx = 0;
        if (leaf) {
          cidx = (int)(head & (kBucket - 1u));
          --len;
          if (len > 0) head = mask[(len - 1) * kWalkThreads];
          ++visits;
        }
        if (pool && __popc(vis) <= kPoolMax) {
          pool_visit(p, s_mem, vis, pool_shift, leaf, cidx, ox, oy, oz, dx,
                     dy, dz, a, o_dot_d, o_dot_o, min_t_a, bq, bs);
          pooled += leaf ? 1u : 0u;
#ifdef RT_WALK_COUNTERS
          RT_COUNT(kWarpPooled, leader_ ? 1u : 0u);
          RT_COUNT(kPoolRounds,
                   leader_ ? (unsigned long long)((__popc(vis) + (32 >>
                                                  pool_shift) - 1) >>
                                                 (5 - pool_shift))
                           : 0ull);
#endif
        } else if (leaf) {
          visit_cluster(p, s_mem, cidx, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                        o_dot_o, min_t_a, bq, bs);
        }
        RT_PHASE(kCycVisit);
      }
      RT_PHASE(kCycWait);
      if (over) {
        // the list overflowed: the bounce starts over as the sweep
        atomicAdd(sweeps_of(p, smem), 1u);
        visits = wide_sweep(p, s_glob, s_par, s_box, s_mem, mask, ox, oy,
                            oz, dx, dy, dz, ivx, ivy, ivz, a, o_dot_d,
                            o_dot_o, min_t_a, bq, bs, tested);
        RT_PHASE(kCycSweep);
#ifdef RT_WALK_COUNTERS
        RT_COUNT(kSweeps, 1u);
        RT_COUNT(kLaneVisit, (unsigned long long)visits);
#endif
      }
      if (idle) continue;
      // the flat walk's iterations: one a visit, at least one
      cost += (float)max(visits, 1);
      n_visits += (uint32_t)visits;
#ifdef RT_WALK_COUNTERS
      RT_COUNT(kLaneTrips, (unsigned long long)max(visits, 1));
      RT_COUNT(kSlabTests, (unsigned long long)tested);
      RT_COUNT(kListMoves, (unsigned long long)moved);
      RT_COUNT(kListPeak, (unsigned long long)peak);
      cnt[kListPeakMax] = max(cnt[kListPeakMax], (unsigned long long)peak);
#endif
    } else {
      bool bdone;
      do {
        cost += 1.0f;
        const bool fresh = kl < kFresh;
#ifdef RT_WALK_COUNTERS
        const unsigned act_ = __activemask();
        const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1;
        RT_COUNT(kWarpTrips, leader_ ? 1u : 0u);
        RT_COUNT(kLaneTrips, 1u);
        RT_WARP_COUNT(kWarpFresh, fresh);
        RT_COUNT(kLaneFresh, fresh ? 1u : 0u);
#endif

        // the boxes to test: on a fresh bounce the children of the parents
        // the ray enters, later the hit boxes not yet visited
        BoxMask<kIsWide ? 1 : kWords> cand = hits;
        if (fresh) {
          // a fresh bounce seeds its best hit with exact global tests
          float g_best = kFillQ;
          int g_slot = 0;
          for (int g = 0; g < p.n_global; ++g) {
#ifdef RT_WALK_MOTION
            float q = moving_q(s_glob + kMotionRow * g, tm, ox, oy, oz, dx,
                               dy, dz, a, o_dot_d, o_dot_o, min_t_a);
#else
            float q = exact_q(s_glob + 4 * g, ox, oy, oz, dx, dy, dz, a,
                              o_dot_d, o_dot_o, min_t_a);
#endif
            if (q < g_best) {
              g_best = q;
              g_slot = g;
            }
          }
          bq = g_best;
          bs = g_slot;
#pragma unroll
          for (int j = 0; j < kWords; ++j) cand.w[j] = 0u;
          for (int q = 0; q < p.n_parents; ++q) {
            RT_COUNT(kSlabTests, 1u);
            if (box_entry(s_par + kBoxFloats * q, ox, oy, oz, ivx, ivy, ivz,
                          a, min_t_a) < kFillQ) {
              const int c0 = kParentFanout * q;
              const int nc = min(kParentFanout, p.k - c0);
              mask_or(cand, c0 >> 5, ((1u << nc) - 1u) << (c0 & 31));
            }
          }
        }

        // slab test of the candidates in q-space, keeping the hit ones and
        // the two nearest packed keys (entry with 7 low bits floored |
        // cluster); every hit key here lies beyond the cursor kl
        float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          uint32_t bits = cand.w[j];
          hits.w[j] = 0u;
          while (bits != 0u) {
            const int c = 32 * j + __ffs(bits) - 1;
            bits &= bits - 1u;
            RT_COUNT(kSlabTests, 1u);
            const float qe = box_entry(s_box + kBoxFloats * c, ox, oy, oz,
                                       ivx, ivy, ivz, a, min_t_a);
            if (qe < kFillQ) {
              hits.w[j] |= 1u << (c & 31);
              const float key =
                  __int_as_float((__float_as_int(qe) & ~127) | c);
              if (key < m0) {
                m1 = m0;
                m0 = key;
              } else if (key < m1) {
                m1 = key;
              }
            }
          }
        }

        // done when the nearest unvisited entry cannot beat the best, or the
        // list is exhausted; else visit it, then test the next one (fused)
        bdone = (key_floor<kWords>(m0) >= bq) | (m0 >= kFillFloor);
        RT_WARP_COUNT(kWarpVisit, !bdone);
        RT_COUNT(kLaneVisit, bdone ? 0u : 1u);
        if (!bdone) {
          const int cidx = __float_as_int(m0) & kKeyMask<kWords>;
          const float4* mb =
              reinterpret_cast<const float4*>(s_mem + 4 * cidx * p.mstride);
#ifdef RT_WALK_MOTION
          n_tests += (uint32_t)p.group;
#endif
          for (int m = 0; m < p.group; ++m) {
#ifdef RT_WALK_MOTION
            float q = moving_q(reinterpret_cast<const float*>(mb + 2 * m),
                               tm, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                               o_dot_o, min_t_a);
#else
            const float4 c4 = mb[m];
            const float c[4] = {c4.x, c4.y, c4.z, c4.w};
            float q = exact_q(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o,
                              min_t_a);
#endif
            if (q < bq) {
              bq = q;
              bs = p.n_global + cidx * p.group + m;
            }
          }
          mask_clear(hits, cidx);
          kl = m0;
          bdone = (key_floor<kWords>(m1) >= bq) | (m1 >= kFillFloor);
        }
      } while (!bdone);
    }
    ++segs;
#ifdef RT_WALK_MOTION
    ++n_bounces;
#endif
#ifdef RT_WALK_COUNTERS
    {
      const unsigned act_ = __activemask();
      const bool leader_ = (int)(threadIdx.x & 31) == __ffs(act_) - 1;
      RT_WARP_COUNT(kWarpTail, true);
      RT_COUNT(kLaneTail, 1u);
    }
#endif

    // --- bounce complete: the shared tail; what only it reads is formed
    // here, so the walk holds two registers less ---
    const uint32_t ctr = (uint32_t)(p.path.sample_offset + path.s) * dps +
                         4u + (uint32_t)path.i * kDrawsPerBounce;
    const float inv_a = 1.0f / a;
#ifdef RT_WALK_MOTION
    float wc[3], wm[7];
    motion_winner(s_win + kMotionWinner * bs, tm, bq, inv_a, path, wc, wm);
    const int next = bounce_tail<kAdaptive, kStratified, kDebug>(
        p.path, s_cam, wc, wm, bq, inv_a, pix, dps, ctr, px, py, limit,
        0.0f, p.dbg, path, sums);
    if (next == kNextSample)
      tm = shutter_time(pix, (uint32_t)(p.path.sample_offset + path.s));
#else
    const float* w = s_win + 11 * bs;
    const int next = bounce_tail<kAdaptive, kStratified, kDebug>(
        p.path, s_cam, w, w + 3, bq, inv_a, pix, dps, ctr, px, py, limit,
        kDebug ? w[10] : 0.0f, p.dbg, path, sums);
#endif
    bq = kFillQ;
    bs = 0;
    kl = kNegBig;
    if (next != kLaneDone) continue;

    // the work has taken its samples: write it, and go on with the next
    // work that has any
    if constexpr (kIsWide) count_walk(p, smem, cost, segs);
    finish<kAdaptive>(p, smem, lane, sums, cost, path, segs);
    for (;;) {
      lane = next_lane(p.next_lane);
      if (lane >= work_end<kAdaptive>(p, smem)) break;
      if (take<kAdaptive>(p, smem, lane, px, py, pix, limit, path.s)) break;
    }
    if (lane >= work_end<kAdaptive>(p, smem)) {
      if constexpr (!kIsWide) break;
      idle = true;
      continue;
    }
    path.i = 0;
    gen_ray<kStratified>(s_cam, p.path,
                         (uint32_t)(p.path.sample_offset + path.s), dps, px,
                         py, pix, path);
    path.cr = path.cg = path.cb = 1.0f;
#ifdef RT_WALK_MOTION
    tm = shutter_time(pix, (uint32_t)(p.path.sample_offset + path.s));
#endif
    sums = {0.0f, 0.0f, 0.0f, 0.0f};
    cost = 0.0f;
    segs = 0;
  }
#ifdef RT_WALK_MOTION
  add_motion_counts(p, n_tests, n_bounces);
#endif
#ifdef RT_WALK_WIDE
  add_visits(p, n_visits, pooled);
#endif
#ifdef RT_WALK_COUNTERS
  if constexpr (kIsWide) RT_PHASE(kCycTail);
  for (int c = 0; c < kNumCounters; ++c) {
    if (c == kListPeakMax)
      atomicMax(&g_counters[c], cnt[c]);
    else
      atomicAdd(&g_counters[c], cnt[c]);
  }
#endif
}

// The end of a wide block: its iteration, bounce and sweep counts into
// the launch's (one atomic each).
__device__ __forceinline__ void end_wide_block(const Params& p,
                                               float* smem) {
  __syncthreads();
  if (threadIdx.x == 0 && p.samples != nullptr) {
    const unsigned long long* c = counts_of(p, smem) + kWalkCountsAt;
    atomicAdd(&p.samples[kWalkIterations], c[kWalkIterations]);
    atomicAdd(&p.samples[kWalkSegments], c[kWalkSegments]);
    atomicAdd(&p.samples[kWalkSweeps],
              (unsigned long long)*sweeps_of(p, smem));
  }
}

template <bool kAdaptive, bool kStratified, bool kDebug, int kWords>
__global__ void __launch_bounds__(kWalkThreads, 1)
    cluster_walk_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kAdaptive) {
    if (threadIdx.x == 0) plan_deal(p, smem);
  }
  if constexpr (kWords == kWide) {
    if (threadIdx.x == 0) {
      unsigned long long* counts = counts_of(p, smem) + kWalkCountsAt;
      counts[kWalkIterations] = counts[kWalkSegments] = 0ull;
      *sweeps_of(p, smem) = 0u;
    }
  }
  load_tables(smem, p.tables, p.n_floats);
  walk<kAdaptive, kStratified, kDebug, kWords>(p, smem);
  if constexpr (kAdaptive) end_block(p, smem);
  if constexpr (kWords == kWide) end_wide_block(p, smem);
}

template <bool kAdaptive, bool kStratified, bool kDebug, int kWords>
cudaError_t launch_words(const Params& p, int blocks, size_t smem,
                         cudaStream_t stream) {
  auto kernel = cluster_walk_kernel<kAdaptive, kStratified, kDebug, kWords>;
  // persistent: as many blocks as fit on every SM at once. The shared-
  // memory limit and that count depend only on the instantiation, the
  // device and the tables' size: worked out again only when one changes.
  static int set_dev = -1, grid_max = 0;
  static size_t set_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_dev || smem != set_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWalkThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    set_dev = dev;
    set_smem = smem;
    grid_max = per_sm * sms;
  }
  if (blocks > grid_max) blocks = grid_max;
  err = cudaMemsetAsync(p.next_lane, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWalkThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the box mask's width from the partition: one word up to 32 clusters;
// the wide walk's library holds the wide walk alone
template <bool kAdaptive, bool kStratified, bool kDebug>
cudaError_t launch(const Params& p, int blocks, size_t smem,
                   cudaStream_t stream) {
#ifdef RT_WALK_WIDE
  return launch_words<kAdaptive, kStratified, kDebug, kWide>(p, blocks, smem,
                                                             stream);
#else
  return p.k <= 32
             ? launch_words<kAdaptive, kStratified, kDebug, 1>(p, blocks,
                                                               smem, stream)
             : launch_words<kAdaptive, kStratified, kDebug, kMaxWords>(
                   p, blocks, smem, stream);
#endif
}

}  // namespace

// Launches the walk's <adaptive, stratified, debug> instantiation on
// `stream`; returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for debug with adaptive, which has none, for
// adaptive without its item scratch or with one of other than kItemRows
// rows, for tables that are not 16-byte aligned, and for a partition of
// more clusters than the library's walk takes (the narrow walk's 128;
// the wide walk's 129 to 512). The packed tables, map, budget (null
// without one), lane counter (one int), live extent (two ints, null
// without a budget), item scratch (item_rows x item_cap floats),
// per-lane item counts (item_cap ints, all zero) and counts (two sample
// counts, or null; in the wide walk seven, never null: the sample counts,
// walk iterations, bounces, sweeps, visits and pooled visits) are device
// pointers; the caller
// checks shapes and the tables' layout. The wide walk's tables end with
// its levels past the grandparents, after the winner rows (a launch whose
// n_floats leaves no room for them is refused). The launch zeroes the
// lane counter on `stream` first, and leaves the item counts zero, so
// launches that share them must share the stream. The cursor and the
// selection are read with debug only.
extern "C" int cluster_walk_launch(
    const float* tables, const int* pixel_map, const int* budget, float* out,
    int* segs, int* next_lane, const int* extent, float* items,
    int* lane_items, unsigned long long* samples, int adaptive, int stratified,
    int debug, int item_rows, int item_cap, int n, int n_global, int k,
    int group, int n_parents, int mstride, int off_glob, int off_par,
    int off_box, int off_mem, int off_win, int n_floats, int wp, int seed,
    int sample_offset, int spp, int max_depth, int rr_depth,
    int exhaust_black, int near_zero_guard, float inv_w, float inv_h,
    float cursor_x, float cursor_y, float cursor_z, float selected,
    void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)tables & 15u) != 0u || (n_floats & 3) != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.path = path_params(wp, seed, sample_offset, spp, max_depth, rr_depth,
                       exhaust_black, near_zero_guard, inv_w, inv_h);
  p.tables = tables;
  p.pixel_map = pixel_map;
  p.budget = budget;
  p.out = out;
  p.segs = segs;
  p.next_lane = next_lane;
  p.extent = extent;
  p.items = items;
  p.lane_items = lane_items;
  p.samples = samples;
  p.item_cap = item_cap;
  p.n = n;
  p.n_global = n_global;
  p.k = k;
  p.group = group;
  p.n_parents = n_parents;
  p.mstride = mstride;
  p.off_glob = off_glob;
  p.off_par = off_par;
  p.off_box = off_box;
  p.off_mem = off_mem;
  p.off_win = off_win;
  p.n_floats = n_floats;
  p.dbg = {cursor_x, cursor_y, cursor_z, selected};
#ifdef RT_WALK_WIDE
  // the wide walk: its hit-test tables (all before the winner rows), its
  // counts and deal, and its threads' masks; then as many more words a
  // thread for its list as the block's shared memory holds
  if (k <= 32 * kMaxWords || k > 32 * kWideMaxWords || samples == nullptr)
    return (int)cudaErrorInvalidValue;
  p.n_floats = off_win;
  p.n_grand = (n_parents + kParentFanout - 1) / kParentFanout;
  p.n_words = (k + 31) / 32;
  // the levels past the grandparents after the winner rows: the third
  // level, the fourth (one or two boxes), and over two the root
  p.n_l3 = (p.n_grand + kParentFanout - 1) / kParentFanout;
  p.n_l4 = (p.n_l3 + kParentFanout - 1) / kParentFanout;
  p.off_top = (off_win + 11 * (n_global + k * group) + 3) / 4 * 4;
  const int n_top = p.n_l3 + p.n_l4 + (p.n_l4 > 1 ? 1 : 0);
  if (n_floats < p.off_top + kBoxFloats * n_top)
    return (int)cudaErrorInvalidValue;
  const size_t need = sizeof(float) * (size_t)off_win + kWideExtraBytes +
                      sizeof(uint32_t) * (size_t)p.n_words * kWalkThreads;
  const size_t word = sizeof(uint32_t) * kWalkThreads;
  p.list_cap = p.n_words + (need < kMaxWalkSmemBytes
                                ? (int)((kMaxWalkSmemBytes - need) / word)
                                : 0);
#ifdef RT_WALK_LIST_CAP
  // a test build's smaller list, so that bounces overflow into the sweep
  p.list_cap = std::min(p.list_cap, RT_WALK_LIST_CAP);
#endif
  const size_t smem =
      need + word * (size_t)std::max(p.list_cap - p.n_words, 0);
#elif defined(RT_WALK_MOTION)
  // the motion walk: fixed spp without the overlay, its counts never null
  if (k > 32 * kMaxWords || adaptive || debug || samples == nullptr)
    return (int)cudaErrorInvalidValue;
  p.n_grand = p.n_words = 0;
  p.n_l3 = p.n_l4 = p.off_top = p.list_cap = 0;
  const size_t smem = sizeof(float) * (size_t)n_floats;
#else
  if (k > 32 * kMaxWords) return (int)cudaErrorInvalidValue;
  p.n_grand = p.n_words = 0;
  p.n_l3 = p.n_l4 = p.off_top = p.list_cap = 0;
  // adaptive: the deal and the sample counts after the tables, and a grid
  // for every sample, as the items may go one a thread
  const size_t smem = sizeof(float) * (size_t)n_floats +
                      (adaptive ? (size_t)kAdaptiveSmemBytes : 0);
#endif
  const long long work = adaptive ? (long long)n * std::max(spp, 1) : n;
  const int blocks = (int)std::min<long long>(
      (work + kWalkThreads - 1) / kWalkThreads, 1 << 20);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef RT_WALK_MOTION
  return (int)(stratified ? launch<false, true, false>(p, blocks, smem, st)
                          : launch<false, false, false>(p, blocks, smem, st));
#else
  if (debug) {
    if (adaptive) return (int)cudaErrorInvalidValue;
    return (int)(stratified ? launch<false, true, true>(p, blocks, smem, st)
                            : launch<false, false, true>(p, blocks, smem, st));
  }
  if (adaptive) {
    if (items == nullptr || lane_items == nullptr ||
        item_rows != kItemRows || item_cap < 0)
      return (int)cudaErrorInvalidValue;
    return (int)(stratified ? launch<true, true, false>(p, blocks, smem, st)
                            : launch<true, false, false>(p, blocks, smem, st));
  }
  return (int)(stratified ? launch<false, true, false>(p, blocks, smem, st)
                          : launch<false, false, false>(p, blocks, smem, st));
#endif
}

// The version of cluster_walk_launch's argument list, raised whenever it
// changes: a caller binds only a library whose version it knows.
extern "C" int cluster_walk_abi() { return 3; }

#ifdef RT_WALK_COUNTERS
// The counter build's totals since the last reset, into `host`
// (kNumCounters entries); returns the cudaError_t.
extern "C" int cluster_walk_counters(unsigned long long* host, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(host, g_counters, sizeof(g_counters));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zeros[kNumCounters] = {};
  return (int)cudaMemcpyToSymbol(g_counters, zeros, sizeof(g_counters));
}
#endif
