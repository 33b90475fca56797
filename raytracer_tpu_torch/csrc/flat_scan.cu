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
// instantiations:
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
// Design. One thread per lane runs the path-regeneration state machine,
// one bounce per loop trip (segments and the cost tick count once per
// trip, as the TPU kernel counts them). The sphere table, 12 floats a
// slot, sits in shared memory; every lane of a warp reads the same row at
// the same time, a broadcast. The running minimum with strict < keeps the
// lowest slot of equal candidates, where the TPU's one-hot gather summed
// the parameters of every tied slot. K2s carries the last-hit slot index
// and reads its row from shared memory, where the TPU kernel carried 11
// gathered floats: the same values in fewer registers. A regenerated lane
// is masked by i == 0 until its first hit.
//
// What bounds it on this card: FP32 issue rate. About 29 operations per
// slot per bounce (26 near-root only), a few hundred per completed
// bounce; device memory sees only the tables, the map and one write per
// lane and row.
//
// Numerics follow the plain PyTorch version
// (raytracer_tpu_torch/render/flat_scan.py) operation for operation:
// build with -fmad=false and without --use_fast_math.

#include "common.cuh"

namespace {

using namespace rt;

constexpr int kRow = 12;  // [cx, cy, cz, k1, 1/r, mat, albedo rgb, fuzz, ior, active]

struct Params {
  PathParams path;
  const float* camera;   // (19,) origin, llc, horizontal, vertical, u, v, lens
  const float* spheres;  // (slots, 12) rows as kRow says
  const int* pixel_map;  // (n, 2) [px, py]
  const int* budget;     // (n,) samples per lane, or null: spp for every lane
  float* out;            // (4, n) rgb sums and bounces, lane order;
                         // (6, n) with sample count and sum of lum^2
  int* segs;             // (n,) completed bounces
  int n, slots;
  int g_full;            // slots [0, g_full) take the full root logic
  DebugUniforms dbg;     // kDebug: cursor point and selection
};

// the near root alone: q_near if q_near >= min_t_a, else kFillQ
__device__ __forceinline__ float near_q(const float* c, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float a, float o_dot_d,
                                        float o_dot_o, float min_t_a) {
  float nb, sq;
  roots(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, nb, sq);
  const float qn = nb - sq;
  return qn >= min_t_a ? qn : kFillQ;
}

// the far root alone, for the self-test
__device__ __forceinline__ float far_q(const float* c, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float a, float o_dot_d,
                                       float o_dot_o) {
  float nb, sq;
  roots(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, nb, sq);
  return nb + sq;
}

// seven blocks an SM: ptxas keeps the kernel within 72 registers, 28
// warps an SM, where the shared tail's merged draw took it to 71-86
// unbounded (64 registers slow K2 on the cover's 487 slots by 6 %)
template <bool kAdaptive, bool kStratified, bool kSplit, bool kDebug>
__global__ void __launch_bounds__(kThreads, 7) flat_scan_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_cam = smem;       // 19, padded to 20
  float* s_tab = smem + 20;  // slots * kRow
  for (int j = threadIdx.x; j < 19; j += blockDim.x) s_cam[j] = p.camera[j];
  for (int j = threadIdx.x; j < kRow * p.slots; j += blockDim.x)
    s_tab[j] = p.spheres[j];
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
  const int g_full = kSplit ? p.g_full : p.slots;

  Path path;
  path.s = 0;
  path.i = 0;
  gen_ray<kStratified>(s_cam, p.path, (uint32_t)p.path.sample_offset, dps, px,
                       py, pix, path);
  path.cr = path.cg = path.cb = 1.0f;
  Sums sums = {0.0f, 0.0f, 0.0f, 0.0f};
  float cost = 0.0f;
  int segs = 0;
  int last = 0;  // K2s: the slot this lane last bounced off

  for (;;) {
    cost += 1.0f;
    ++segs;
    const float ox = path.ox, oy = path.oy, oz = path.oz;
    const float dx = path.dx, dy = path.dy, dz = path.dz;
    const uint32_t ctr = (uint32_t)(p.path.sample_offset + path.s) * dps +
                         4u + (uint32_t)path.i * kDrawsPerBounce;
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;
    const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
    const float o_dot_o = dot3(ox, oy, oz, ox, oy, oz);
    const float min_t_a = kMinT * a;

    // the closest candidate over every slot; strict < keeps the lowest
    // slot of equal candidates
    float bq = kFillQ;
    int bs = 0;
    for (int j = 0; j < g_full; ++j) {
      const float q = exact_q(s_tab + kRow * j, ox, oy, oz, dx, dy, dz, a,
                              o_dot_d, o_dot_o, min_t_a);
      if (q < bq) {
        bq = q;
        bs = j;
      }
    }
    if (kSplit) {
      for (int j = g_full; j < p.slots; ++j) {
        const float q = near_q(s_tab + kRow * j, ox, oy, oz, dx, dy, dz, a,
                               o_dot_d, o_dot_o, min_t_a);
        if (q < bq) {
          bq = q;
          bs = j;
        }
      }
      // the far root of the sphere the origin sits on, mid-path only;
      // strict <: a containable winner that ties bitwise keeps its slot
      if (path.i >= 1) {
        const float qf = far_q(s_tab + kRow * last, ox, oy, oz, dx, dy, dz, a,
                               o_dot_d, o_dot_o);
        if (qf >= min_t_a && qf < bq) {
          bq = qf;
          bs = last;
        }
      }
    }

    const float* row = s_tab + kRow * bs;
    const int r = bounce_tail<kAdaptive, kStratified, kDebug>(
        p.path, s_cam, row, row + 4, bq, inv_a, pix, dps, ctr, px, py, limit,
        kDebug ? (float)bs : 0.0f, p.dbg, path, sums);
    if (r == kLaneDone) break;
    if (kSplit && r == kPathGoesOn) last = bs;
  }

  write_lane<kAdaptive>(p.out, p.segs, p.n, lane, sums, cost, path, segs);
}

template <bool kAdaptive, bool kStratified, bool kSplit, bool kDebug>
cudaError_t launch(const Params& p, int blocks, size_t smem,
                   cudaStream_t stream) {
  flat_scan_kernel<kAdaptive, kStratified, kSplit, kDebug>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kAdaptive, bool kStratified>
cudaError_t launch_split(const Params& p, int split, int blocks, size_t smem,
                         cudaStream_t st) {
  return split
             ? launch<kAdaptive, kStratified, true, false>(p, blocks, smem, st)
             : launch<kAdaptive, kStratified, false, false>(p, blocks, smem,
                                                             st);
}

// shared memory of one block for a table of `slots` rows, in bytes (the
// caller checks the same size against the card's default limit)
size_t smem_bytes(int slots) { return sizeof(float) * (20 + kRow * slots); }

}  // namespace

// Launches the scan's <adaptive, stratified, split, debug> instantiation
// on `stream`; returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for debug with adaptive or split, which have
// none. Tables, map and budget (null without one) are device pointers;
// the caller checks shapes and the shared-memory size. The cursor and
// the selection are read with debug only.
extern "C" int flat_scan_launch(
    const float* camera, const float* spheres, const int* pixel_map,
    const int* budget, float* out, int* segs, int adaptive, int stratified,
    int split, int debug, int n, int slots, int g_full, int wp, int seed,
    int sample_offset, int spp, int max_depth, int rr_depth,
    int exhaust_black, int near_zero_guard, float inv_w, float inv_h,
    float cursor_x, float cursor_y, float cursor_z, float selected,
    void* stream) {
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
  p.n = n;
  p.slots = slots;
  p.g_full = g_full < slots ? g_full : slots;
  p.dbg = {cursor_x, cursor_y, cursor_z, selected};
  const size_t smem = smem_bytes(slots);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (debug) {
    if (adaptive || split) return (int)cudaErrorInvalidValue;
    return (int)(stratified
                     ? launch<false, true, false, true>(p, blocks, smem, st)
                     : launch<false, false, false, true>(p, blocks, smem, st));
  }
  if (adaptive)
    return (int)(stratified ? launch_split<true, true>(p, split, blocks, smem, st)
                            : launch_split<true, false>(p, split, blocks, smem, st));
  return (int)(stratified ? launch_split<false, true>(p, split, blocks, smem, st)
                          : launch_split<false, false>(p, split, blocks, smem, st));
}

// The version of flat_scan_launch's argument list, raised whenever it
// changes: a caller binds only a library whose version it knows.
extern "C" int flat_scan_abi() { return 1; }
