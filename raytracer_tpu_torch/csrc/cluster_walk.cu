// The gathered cluster walk on Hopper: one spp chunk for every lane of a
// lane->pixel map.
//
// Replaces the cluster-walk variants of the TPU kernel
// raytracer_tpu/render/pallas_kernel.py `_make_kernel(...).kernel`
// (launched by `_render_chunk_impl`) in its production configuration:
// kd partition with box bounds, one cluster per walk step, packed visit
// key, fused bounce-done test. Three template parameters give its six
// instantiations:
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
// Design. One thread per lane, one lane per pixel of the chunk's map.
// Each thread runs the TPU kernel's path-regeneration state machine
// alone: counters s (sample) and i (bounce), walk state (bq, bs, kl) and
// throughput, one walk iteration per loop trip. The TPU's K-slot virtual
// tiles, r_sub row tiling and 128-lane tile grid existed to balance
// 1024-lane vector tiles and are gone; a warp waits only for its slowest
// of 32 lanes, and each lane's 100+ samples average its path lengths.
// The scene tables (box bounds, cluster members, winner parameters,
// globals) and the camera are copied into shared memory once per block
// and read with direct indexed loads, where the TPU needed one-hot and
// banked lane gathers.
//
// What bounds it on this card: FP32 issue rate and branch divergence.
// The work is arithmetic on registers (about 36 operations per cluster
// box per walk iteration, 30 per member sphere, a few hundred per
// completed bounce); device memory sees only the tables and one write
// per lane and channel. Lanes of a warp diverge between walk iterations
// (mid-walk) and bounce tails (completed); the design keeps the tail
// behind one branch so a warp runs at most two paths per trip.
//
// The RNG, ray generation and the bounce tail live in common.cuh, shared
// with the flat scan (flat_scan.cu). Numerics follow the plain PyTorch
// version (raytracer_tpu_torch/render/cluster_walk.py) operation for
// operation: build with -fmad=false and without --use_fast_math.
// Constants are the float32 roundings of the JAX package's Python
// doubles, as hex literals.

#include "common.cuh"

namespace {

using namespace rt;

struct Params {
  PathParams path;
  const float* camera;   // (19,) origin, llc, horizontal, vertical, u, v, lens
  const float* globals;  // (n_global, 4) [cx, cy, cz, k1]
  const float* bounds;   // (k, 6) [lo xyz, hi xyz]
  const float* members;  // (k, group, 4) [cx, cy, cz, k1]
  const float* winner;   // (slots, 11) [c xyz, 1/r, mat, albedo rgb, fuzz, ior, uuid]
  const int* pixel_map;  // (n, 2) [px, py]
  const int* budget;     // (n,) samples per lane, or null: spp for every lane
  float* out;            // (4, n) rgb sums and walk iterations, lane order;
                         // (6, n) with sample count and sum of lum^2
  int* segs;             // (n,) completed bounces
  int n, n_global, k, group, slots;
  DebugUniforms dbg;     // kDebug: cursor point and selection
};

__device__ __forceinline__ float key_floor(float key) {
  return __int_as_float(__float_as_int(key) & ~127);
}

// direction reciprocal clamped away from zero: no slab product reaches inf
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d >= 0.0f ? fmaxf(d, kUEps) : fminf(d, -kUEps));
}

__host__ __device__ constexpr int smem_floats(int n_global, int k, int group,
                                              int slots) {
  return 20 + 4 * n_global + 6 * k + 4 * k * group + 11 * slots;
}

template <bool kAdaptive, bool kStratified, bool kDebug>
__global__ void __launch_bounds__(kThreads) cluster_walk_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_cam = smem;                       // 19, padded to 20
  float* s_glob = s_cam + 20;                // n_global * 4
  float* s_bnd = s_glob + 4 * p.n_global;    // k * 6
  float* s_mem = s_bnd + 6 * p.k;            // k * group * 4
  float* s_win = s_mem + 4 * p.k * p.group;  // slots * 11
  for (int j = threadIdx.x; j < 19; j += blockDim.x) s_cam[j] = p.camera[j];
  for (int j = threadIdx.x; j < 4 * p.n_global; j += blockDim.x)
    s_glob[j] = p.globals[j];
  for (int j = threadIdx.x; j < 6 * p.k; j += blockDim.x)
    s_bnd[j] = p.bounds[j];
  for (int j = threadIdx.x; j < 4 * p.k * p.group; j += blockDim.x)
    s_mem[j] = p.members[j];
  for (int j = threadIdx.x; j < 11 * p.slots; j += blockDim.x)
    s_win[j] = p.winner[j];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;

  float px, py;
  uint32_t pix;
  int limit;  // samples this lane takes
  if (!lane_setup<kAdaptive>(p.path, p.pixel_map, p.budget, p.out, p.segs,
                             p.n, lane, px, py, pix, limit))
    return;
  const uint32_t dps = 4u + (uint32_t)p.path.max_depth * kDrawsPerBounce;

  Path path;
  path.s = 0;
  path.i = 0;
  gen_ray<kStratified>(s_cam, p.path, (uint32_t)p.path.sample_offset, dps, px,
                       py, pix, path);
  path.cr = path.cg = path.cb = 1.0f;
  float bq = kFillQ, kl = kNegBig;  // best q, visited cursor (packed key)
  int bs = 0;                       // winner slot
  Sums sums = {0.0f, 0.0f, 0.0f, 0.0f};
  float cost = 0.0f;
  int segs = 0;

  for (;;) {
    cost += 1.0f;
    const float ox = path.ox, oy = path.oy, oz = path.oz;
    const float dx = path.dx, dy = path.dy, dz = path.dz;
    const uint32_t ctr = (uint32_t)(p.path.sample_offset + path.s) * dps +
                         4u + (uint32_t)path.i * kDrawsPerBounce;
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;
    const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
    const float o_dot_o = dot3(ox, oy, oz, ox, oy, oz);
    const float min_t_a = kMinT * a;

    if (kl < kFresh) {
      // a fresh bounce seeds its best hit with exact global tests
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

    // slab test of every box in q-space, keeping the two nearest
    // unvisited packed keys (entry with 7 low bits floored | cluster)
    const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
    float m0 = INFINITY, m1 = INFINITY;
    for (int c = 0; c < p.k; ++c) {
      const float* b = s_bnd + 6 * c;
      float t1 = (b[0] - ox) * ivx, t2 = (b[3] - ox) * ivx;
      float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
      t1 = (b[1] - oy) * ivy;
      t2 = (b[4] - oy) * ivy;
      tn = fmaxf(tn, fminf(t1, t2));
      tf = fminf(tf, fmaxf(t1, t2));
      t1 = (b[2] - oz) * ivz;
      t2 = (b[5] - oz) * ivz;
      tn = fmaxf(tn, fminf(t1, t2));
      tf = fminf(tf, fmaxf(t1, t2));
      const float qn = fmaxf(tn * a, min_t_a);
      const bool hitb = (tf >= tn) & (tf * a >= min_t_a) & (qn < kQCut);
      const float qe = hitb ? qn : kFillQ;
      const float key = __int_as_float((__float_as_int(qe) & ~127) | c);
      if (key > kl) {
        if (key < m0) {
          m1 = m0;
          m0 = key;
        } else if (key < m1) {
          m1 = key;
        }
      }
    }

    // done when the nearest unvisited entry cannot beat the best, or the
    // list is exhausted; else visit it, then test the next one (fused)
    bool bdone = (key_floor(m0) >= bq) | (m0 >= kFillFloor);
    if (!bdone) {
      const int cidx = __float_as_int(m0) & 127;
      const float* mb = s_mem + 4 * cidx * p.group;
      for (int m = 0; m < p.group; ++m) {
        float q = exact_q(mb + 4 * m, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                          o_dot_o, min_t_a);
        if (q < bq) {
          bq = q;
          bs = p.n_global + cidx * p.group + m;
        }
      }
      kl = m0;
      bdone = (key_floor(m1) >= bq) | (m1 >= kFillFloor);
    }
    if (!bdone) continue;
    ++segs;

    // --- bounce complete: the shared tail ---
    const float* w = s_win + 11 * bs;
    if (bounce_tail<kAdaptive, kStratified, kDebug>(
            p.path, s_cam, w, w + 3, bq, inv_a, pix, dps, ctr, px, py, limit,
            kDebug ? w[10] : 0.0f, p.dbg, path, sums) == kLaneDone)
      break;
    bq = kFillQ;
    bs = 0;
    kl = kNegBig;
  }

  write_lane<kAdaptive>(p.out, p.segs, p.n, lane, sums, cost, path, segs);
}

template <bool kAdaptive, bool kStratified, bool kDebug>
cudaError_t launch(const Params& p, int blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_walk_kernel<kAdaptive, kStratified, kDebug>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cluster_walk_kernel<kAdaptive, kStratified, kDebug>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the walk's <adaptive, stratified, debug> instantiation on
// `stream`; returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for debug with adaptive, which has none. Tables,
// map and budget (null without one) are device pointers; the caller
// checks shapes. The cursor and the selection are read with debug only.
extern "C" int cluster_walk_launch(
    const float* camera, const float* globals, const float* bounds,
    const float* members, const float* winner, const int* pixel_map,
    const int* budget, float* out, int* segs, int adaptive, int stratified,
    int debug, int n, int n_global, int k, int group, int wp,
    int seed, int sample_offset, int spp, int max_depth, int rr_depth,
    int exhaust_black, int near_zero_guard, float inv_w, float inv_h,
    float cursor_x, float cursor_y, float cursor_z, float selected,
    void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.path = path_params(wp, seed, sample_offset, spp, max_depth, rr_depth,
                       exhaust_black, near_zero_guard, inv_w, inv_h);
  p.camera = camera;
  p.globals = globals;
  p.bounds = bounds;
  p.members = members;
  p.winner = winner;
  p.pixel_map = pixel_map;
  p.budget = budget;
  p.out = out;
  p.segs = segs;
  p.n = n;
  p.n_global = n_global;
  p.k = k;
  p.group = group;
  p.slots = n_global + k * group;
  p.dbg = {cursor_x, cursor_y, cursor_z, selected};
  const size_t smem =
      sizeof(float) * (size_t)smem_floats(n_global, k, group, p.slots);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (debug) {
    if (adaptive) return (int)cudaErrorInvalidValue;
    return (int)(stratified ? launch<false, true, true>(p, blocks, smem, st)
                            : launch<false, false, true>(p, blocks, smem, st));
  }
  if (adaptive)
    return (int)(stratified ? launch<true, true, false>(p, blocks, smem, st)
                            : launch<true, false, false>(p, blocks, smem, st));
  return (int)(stratified ? launch<false, true, false>(p, blocks, smem, st)
                          : launch<false, false, false>(p, blocks, smem, st));
}
