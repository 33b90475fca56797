// What the port's two closest-hit kernels share: constants, the
// counter-hash RNG and the stratified sampler's Kronecker draws, camera
// ray generation, the exact sphere quadratic, and the bounce tail
// (scatter, terminate, regenerate). Counterpart of the shared parts of
// raytracer_tpu/render/pallas_kernel.py `_make_kernel(...).kernel`:
// `gen_ray`, the tail after the closest-hit scan, and the module's
// `_lowbias32` ... `_unit_sphere` and `_r2_fixed`.
//
// Included by cluster_walk.cu (K1) and flat_scan.cu (K2, K2s), which also
// share the persistent grid's lane dealing; the plain PyTorch versions
// share the same tail in raytracer_tpu_torch/render/cluster_walk.py
// `bounce_tail`.
//
// Numerics: build with -fmad=false and without --use_fast_math, so every
// product and sum rounds on its own as in the plain versions. Constants
// are the float32 roundings of the JAX package's Python doubles, as hex
// literals.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float kFillQ = 0x1.c363ccp+127f;       // 3e38: no candidate
constexpr float kNegBig = -0x1.c363ccp+127f;     // -3e38: poisoned root
constexpr float kFresh = -0x1.2ced32p+126f;      // -1e38: fresh cursor
constexpr float kFillFloor = 0x1.c363p+127f;     // 3e38, 7 low bits clear
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kInv24 = 0x1p-24f;
constexpr float kOneThird = 0x1.555556p-2f;
constexpr float kMinT = 0x1.0624dep-10f;         // 0.001
constexpr float kUEps = 0x1.197998p-40f;         // 1e-12
constexpr float kNEps = 0x1.79ca1p-67f;          // 1e-20
constexpr float kQCut = 0x1.5af1d8p+66f;         // 1e20
constexpr float kSkyG = 0x1.333334p-2f;          // 0.3
constexpr float kRRMin = 0x1.99999ap-5f;         // 0.05
constexpr float kNearZero = 0x1.5798eep-27f;     // 1e-8
// debug overlay: a hit within 0.1 of the cursor (squared distance below
// 0.01) is the marker; the selection outline is where d.n > -0.05
constexpr float kCursorR2 = 0x1.47ae14p-7f;      // 0.01
constexpr float kGrazing = -0x1.99999ap-5f;      // -0.05
// the material code of a lane the overlay marked: like any code past
// glass, it absorbs (no scatter)
constexpr float kMarked = 0x1.8p+1f;             // 3.0
// stratified sampler: alphas as round(alpha * 2^32), and the counters of
// the per-pixel rotations (-4 camera, -8 first bounce)
constexpr uint32_t kA4Fix0 = 0xC13FA9A9u;   // 1/g, g^3 = g + 1: jitter u
constexpr uint32_t kA4Fix1 = 0x91E10DA6u;   // 1/g^2: jitter v
constexpr uint32_t kA4Fix2 = 0x6A09E668u;   // sqrt(2) - 1: lens u
constexpr uint32_t kA4Fix3 = 0xBB67AE86u;   // sqrt(3) - 1: lens v
constexpr uint32_t kAB0Fix0 = 0xAEAD08F3u;  // 1/h, h^3 = h^2 + 1: diffuse hx
constexpr uint32_t kAB0Fix1 = 0x772FAD1Fu;  // 1/h^2: diffuse phi
constexpr uint32_t kAB0Fix2 = 0x9E3779B9u;  // (sqrt(5) - 1)/2: glass roll
constexpr uint32_t kRotCamera = 0xFFFFFFFCu;
constexpr uint32_t kRotBounce0 = 0xFFFFFFF8u;
constexpr int kDrawsPerBounce = 8;
constexpr int kThreads = 128;

// What every lane's path needs besides the scene: the launch's sample
// range and tracing options.
struct PathParams {
  int wp;                // image width padded to 128: the RNG's row stride
  uint32_t seed;
  int sample_offset, spp, max_depth, rr_depth;
  int exhaust_black, near_zero_guard;
  float inv_w, inv_h;    // float32(1/W), float32(1/H), rounded on the host
};

// The debug overlay's uniforms, by value (the TPU kernel's slots 19-22):
// the cursor point and the selected sphere's id as float32.
struct DebugUniforms {
  float cx, cy, cz;
  float sel;
};

// One lane's path: ray, throughput, sample and bounce counters.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float cr, cg, cb;
  int s, i;
};

// One lane's sums over its samples.
struct Sums {
  float r, g, b;
  float l2;  // adaptive: sum of squared sample luminances
};

// What became of a path at the end of its bounce.
enum TailResult { kPathGoesOn = 0, kNextSample = 1, kLaneDone = 2 };

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// uniform [0, 1) draw: hash(pixel ^ golden * (ctr + salt)), top 24 bits
__device__ __forceinline__ float u01(uint32_t pix, uint32_t ctr,
                                     uint32_t salt) {
  uint32_t h = lowbias32(pix ^ ((ctr + salt) * 0x9E3779B9u));
  return (float)(int)(h >> 8) * kInv24;
}

// the s_u-th Kronecker point of dimension d: the pixel's hash at counter
// rot + d is the rotation, and rotation + s * alpha wraps mod 2^32
__device__ __forceinline__ float r2_fixed(uint32_t pix, uint32_t rot,
                                          uint32_t d, uint32_t s_u,
                                          uint32_t a_fix) {
  uint32_t x = lowbias32(pix ^ ((rot + d) * 0x9E3779B9u)) + s_u * a_fix;
  return (float)(int)(x >> 8) * kInv24;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = rsqrtf(fmaxf(dot3(x, y, z, x, y, z), kNEps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// the sphere quadratic in q-space (q = t*|d|^2) of the sphere [cx, cy,
// cz] with k1 = |c|^2 - r^2: half its b, nb, and its discriminant ds
__device__ __forceinline__ void discriminant(float cx, float cy, float cz,
                                             float k1, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float a,
                                             float o_dot_d, float o_dot_o,
                                             float& nb, float& ds) {
  float cdd = dot3(cx, cy, cz, dx, dy, dz);
  float cdo = dot3(cx, cy, cz, ox, oy, oz);
  nb = cdd - o_dot_d;
  float cc = o_dot_o - 2.0f * cdo + k1;
  ds = nb * nb - a * cc;
}

// the roots' half-distance sq of a discriminant: a negative one poisons
// it to -3e38, never NaN
__device__ __forceinline__ float root_of(float ds) {
  return ds >= 0.0f ? sqrtf(fabsf(ds)) : kNegBig;
}

// the sphere quadratic's roots nb -/+ sq; c = [cx, cy, cz, k1]
__device__ __forceinline__ void roots(const float* c, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float a, float o_dot_d, float o_dot_o,
                                      float& nb, float& sq) {
  float ds;
  discriminant(c[0], c[1], c[2], c[3], ox, oy, oz, dx, dy, dz, a, o_dot_d,
               o_dot_o, nb, ds);
  sq = root_of(ds);
}

// nearest root q with t >= MIN_T (near root, else far root), kFillQ when
// there is none
__device__ __forceinline__ float exact_q(const float* c, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float a, float o_dot_d,
                                         float o_dot_o, float min_t_a) {
  float nb, sq;
  roots(c, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, nb, sq);
  float qn = nb - sq;
  float q = qn >= min_t_a ? qn : nb + sq;
  return q >= min_t_a ? q : kFillQ;
}

// camera ray of absolute sample index s_abs, whose counter block starts
// at s_abs * dps
template <bool kStratified>
__device__ __forceinline__ void gen_ray(const float* cam, const PathParams& p,
                                        uint32_t s_abs, uint32_t dps,
                                        float px, float py, uint32_t pix,
                                        Path& path) {
  float u0, u1, u2, u3;
  if (kStratified) {
    u0 = r2_fixed(pix, kRotCamera, 0, s_abs, kA4Fix0);
    u1 = r2_fixed(pix, kRotCamera, 1, s_abs, kA4Fix1);
    u2 = r2_fixed(pix, kRotCamera, 2, s_abs, kA4Fix2);
    u3 = r2_fixed(pix, kRotCamera, 3, s_abs, kA4Fix3);
  } else {
    const uint32_t ctr0 = s_abs * dps;
    u0 = u01(pix, ctr0, 0);
    u1 = u01(pix, ctr0, 1);
    u2 = u01(pix, ctr0, 2);
    u3 = u01(pix, ctr0, 3);
  }
  float st_s = (px + 0.5f + u0) * p.inv_w;
  float st_t = (py + 0.5f + u1) * p.inv_h;
  float ang = u2 * kTwoPi;
  float rad = cam[18] * sqrtf(u3);
  float rdx = rad * cosf(ang);
  float rdy = rad * sinf(ang);
  path.ox = cam[0] + (cam[12] * rdx + cam[15] * rdy);
  path.oy = cam[1] + (cam[13] * rdx + cam[16] * rdy);
  path.oz = cam[2] + (cam[14] * rdx + cam[17] * rdy);
  path.dx = cam[3] + st_s * cam[6] + st_t * cam[9] - path.ox;
  path.dy = cam[4] + st_s * cam[7] + st_t * cam[10] - path.oy;
  path.dz = cam[5] + st_s * cam[8] + st_t * cam[11] - path.oz;
}

// The camera ray of the lane's sample path.s, full throughput, bounce 0.
template <bool kStratified>
__device__ __forceinline__ void start_sample(const float* cam,
                                             const PathParams& p,
                                             uint32_t dps, float px, float py,
                                             uint32_t pix, Path& path) {
  gen_ray<kStratified>(cam, p, (uint32_t)(p.sample_offset + path.s), dps, px,
                       py, pix, path);
  path.cr = path.cg = path.cb = 1.0f;
  path.i = 0;
}

// The bounce tail, for a lane whose closest hit is known: best q `bq`
// (kFillQ on a miss) and the winner's parameters, wc = its center and
// wm = [1/r, mat, albedo rgb, fuzz, ior]. Front-face normal; diffuse,
// metal or glass scatter; sky on a miss; Russian roulette; depth
// exhaustion; the contribution into `sums`; then either the path goes on
// from the hit point, or the lane starts its next sample, or it has
// taken `limit` samples and is done.
//
// kDebug (the TPU kernel's `enable_debug`): a hit within 0.1 of the
// cursor paints the marker, blue (0, 0, 1); else a hit on the selected
// sphere (`uuid` == dbg.sel) at grazing incidence (raw direction dot
// front-corrected normal above -0.05) paints the outline, red (1, 0, 0).
// A marked lane takes that fixed colour, unscaled by throughput, and
// does not scatter: its path ends and its next sample starts.
template <bool kAdaptive, bool kStratified, bool kDebug>
__device__ __forceinline__ int bounce_tail(
    const PathParams& p, const float* cam, const float* wc, const float* wm,
    float bq, float inv_a, uint32_t pix, uint32_t dps, uint32_t ctr,
    float px, float py, int limit, float uuid, const DebugUniforms& dbg,
    Path& path, Sums& sums) {
  float best_t = bq * inv_a;
  const bool hit = best_t < kQCut;
  float udx = path.dx, udy = path.dy, udz = path.dz;
  normalize3(udx, udy, udz);
  float con_r = 0.0f, con_g = 0.0f, con_b = 0.0f;
  bool scat = false;
  float hpx = 0.0f, hpy = 0.0f, hpz = 0.0f;
  float ndx = 0.0f, ndy = 0.0f, ndz = 0.0f;
  if (!hit) {
    // sky, with the throughput before this bounce
    const float sky_t = 0.5f * (udy + 1.0f);
    con_r = path.cr * (1.0f - 0.5f * sky_t);
    con_g = path.cg * (1.0f - kSkyG * sky_t);
    con_b = path.cb;
  } else {
    const float dx = path.dx, dy = path.dy, dz = path.dz;
    hpx = path.ox + best_t * dx;
    hpy = path.oy + best_t * dy;
    hpz = path.oz + best_t * dz;
    float nx = (hpx - wc[0]) * wm[0];
    float ny = (hpy - wc[1]) * wm[0];
    float nz = (hpz - wc[2]) * wm[0];
    const bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    nx = nx * sgn;
    ny = ny * sgn;
    nz = nz * sgn;
    bool marked = false;
    if (kDebug) {
      const float dcx = hpx - dbg.cx, dcy = hpy - dbg.cy, dcz = hpz - dbg.cz;
      const bool cursor_hit = dcx * dcx + dcy * dcy + dcz * dcz < kCursorR2;
      const bool outline = !cursor_hit && uuid == dbg.sel &&
                           dot3(dx, dy, dz, nx, ny, nz) > kGrazing;
      if (cursor_hit || outline) {
        con_r = outline ? 1.0f : 0.0f;
        con_b = cursor_hit ? 1.0f : 0.0f;
        marked = true;
      }
    }
    const float mat = (kDebug && marked) ? kMarked : wm[1];
    // diffuse and metal draw their random vector in one place, so a warp
    // whose lanes mix the two, or a stratified first bounce with later
    // ones, runs the transcendentals once: a point in the unit ball,
    // exp(log(u)/3) its radius (diffuse normalises it), or on a sample's
    // first stratified diffuse bounce a point on the unit sphere
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    if (mat < 1.5f) {
      const bool diffuse = mat < 0.5f;
      const bool strat0 = kStratified && diffuse && path.i == 0;
      float hx, phi, r = 1.0f;
      if (strat0) {
        const uint32_t s_u = (uint32_t)(p.sample_offset + path.s);
        hx = r2_fixed(pix, kRotBounce0, 0, s_u, kAB0Fix0) * 2.0f - 1.0f;
        phi = r2_fixed(pix, kRotBounce0, 1, s_u, kAB0Fix1) * kTwoPi;
      } else {
        const uint32_t salt = diffuse ? 0u : 3u;
        hx = u01(pix, ctr, salt) * 2.0f - 1.0f;
        phi = u01(pix, ctr, salt + 1) * kTwoPi;
        r = expf(logf(fmaxf(u01(pix, ctr, salt + 2), kUEps)) * kOneThird);
      }
      const float s = sqrtf(fmaxf(1.0f - hx * hx, 0.0f));
      const float rs = strat0 ? s : r * s;
      vx = rs * sinf(phi);
      vy = rs * cosf(phi);
      vz = strat0 ? hx : r * hx;
      if (diffuse && !strat0) normalize3(vx, vy, vz);
    }
    if (mat < 0.5f) {  // diffuse
      ndx = nx + vx;
      ndy = ny + vy;
      ndz = nz + vz;
      if (p.near_zero_guard && fabsf(ndx) < kNearZero &&
          fabsf(ndy) < kNearZero && fabsf(ndz) < kNearZero) {
        ndx = nx;
        ndy = ny;
        ndz = nz;
      }
      scat = true;
    } else if (mat < 1.5f) {  // metal: reflect + fuzz
      const float d_dot_n = dot3(dx, dy, dz, nx, ny, nz);
      const float fuzz = wm[5];
      ndx = dx - 2.0f * d_dot_n * nx + fuzz * vx;
      ndy = dy - 2.0f * d_dot_n * ny + fuzz * vy;
      ndz = dz - 2.0f * d_dot_n * nz + fuzz * vz;
      scat = dot3(nx, ny, nz, ndx, ndy, ndz) > 0.0f;
    } else if (mat < 2.5f) {  // glass: Snell + TIR + Schlick roll
      const float refr = wm[6];
      const float ratio = front ? 1.0f / refr : refr;
      const float cos_t = fminf(-dot3(udx, udy, udz, nx, ny, nz), 1.0f);
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const bool cannot = ratio * sin_t > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float one_m = 1.0f - cos_t;
      const float one_m2 = one_m * one_m;
      const float schlick = r0 + (1.0f - r0) * one_m2 * one_m2 * one_m;
      const float glass_u =
          (kStratified && path.i == 0)
              ? r2_fixed(pix, kRotBounce0, 2,
                         (uint32_t)(p.sample_offset + path.s), kAB0Fix2)
              : u01(pix, ctr, 6);
      if (cannot || schlick > glass_u) {
        const float ud_dot_n = dot3(udx, udy, udz, nx, ny, nz);
        ndx = udx - 2.0f * ud_dot_n * nx;
        ndy = udy - 2.0f * ud_dot_n * ny;
        ndz = udz - 2.0f * ud_dot_n * nz;
      } else {
        const float rpx = ratio * (udx + cos_t * nx);
        const float rpy = ratio * (udy + cos_t * ny);
        const float rpz = ratio * (udz + cos_t * nz);
        const float kk =
            fmaxf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0f);
        const float sk = sqrtf(kk);
        ndx = rpx - sk * nx;
        ndy = rpy - sk * ny;
        ndz = rpz - sk * nz;
      }
      scat = true;
    }  // any other material code absorbs
    if (scat) {
      path.cr = path.cr * wm[2];
      path.cg = path.cg * wm[3];
      path.cb = path.cb * wm[4];
    }
  }
  if (p.rr_depth > 0 && path.i >= p.rr_depth) {
    // survive with p = max(throughput) in [0.05, 1], reweighted by 1/p
    const float p_surv =
        fminf(fmaxf(fmaxf(path.cr, fmaxf(path.cg, path.cb)), kRRMin), 1.0f);
    const bool survive = u01(pix, ctr, 7) < p_surv;
    if (survive && scat) {
      const float boost = 1.0f / p_surv;
      path.cr = path.cr * boost;
      path.cg = path.cg * boost;
      path.cb = path.cb * boost;
    }
    scat = scat && survive;
  }
  const bool exhausted = scat && path.i >= p.max_depth - 1;
  if (exhausted && !p.exhaust_black) {
    con_r = path.cr;
    con_g = path.cg;
    con_b = path.cb;
  }
  sums.r = sums.r + con_r;
  sums.g = sums.g + con_g;
  sums.b = sums.b + con_b;
  if (kAdaptive) {
    // the sample's luminance: zero unless the path ended with light
    const float lum = (con_r + con_g + con_b) * kOneThird;
    sums.l2 = sums.l2 + lum * lum;
  }

  if (scat && !exhausted) {
    path.ox = hpx;
    path.oy = hpy;
    path.oz = hpz;
    path.dx = ndx;
    path.dy = ndy;
    path.dz = ndz;
    ++path.i;
    return kPathGoesOn;
  }
  // the path ended: regenerate the lane's next sample, if any
  ++path.s;
  if (path.s >= limit) return kLaneDone;
  start_sample<kStratified>(cam, p, dps, px, py, pix, path);
  return kNextSample;
}

// Lanes of a persistent grid, as both kernels deal them. The grid's
// threads start on lanes 0 .. grid - 1, warp w of block b on the 32 lanes
// from 32 (w gridDim + b): the map's head spreads over every block, its
// consecutive lanes stay in one warp.
__device__ __forceinline__ int first_lane() {
  const int warp = (int)(threadIdx.x >> 5);
  return 32 * (warp * (int)gridDim.x + (int)blockIdx.x) +
         (int)(threadIdx.x & 31);
}

// A thread whose lane is done takes the next untaken lane of the map:
// `counter` counts the lanes taken past the grid's own. One atomic a warp
// for the lanes of the warp that ask together.
__device__ __forceinline__ int next_lane(int* counter) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, (int)g.size());
  base = g.shfl(base, 0);
  return (int)(gridDim.x * blockDim.x) + base + (int)g.thread_rank();
}

// The lane's setup shared by both kernels: its pixel, the pixel's hash
// and its sample limit (its own budget when adaptive, else the chunk's
// spp). A lane without budget writes zeros to all `rows` output rows and
// its segment count, and reports false: it has nothing to do.
template <bool kAdaptive>
__device__ __forceinline__ bool lane_setup(const PathParams& p,
                                           const int* pixel_map,
                                           const int* budget, float* out,
                                           int* segs, int n, int lane,
                                           float& px, float& py,
                                           uint32_t& pix, int& limit) {
  const int ipx = pixel_map[2 * lane], ipy = pixel_map[2 * lane + 1];
  px = (float)ipx;
  py = (float)ipy;
  const uint32_t gid = (uint32_t)ipy * (uint32_t)p.wp + (uint32_t)ipx;
  pix = lowbias32(gid ^ p.seed);
  limit = p.spp;
  if (kAdaptive) {
    if (budget != nullptr) limit = budget[lane];
    if (limit <= 0) {
      // a converged pixel: dead at launch, all sums zero
      for (int c = 0; c < 6; ++c) out[c * n + lane] = 0.0f;
      segs[lane] = 0;
      return false;
    }
  }
  return true;
}

// The lane's sums, cost and segment count, in lane order: rows r, g, b,
// cost, and when adaptive the completed-sample count and sum of lum^2.
template <bool kAdaptive>
__device__ __forceinline__ void write_lane(float* out, int* segs, int n,
                                           int lane, const Sums& sums,
                                           float cost, const Path& path,
                                           int nsegs) {
  out[lane] = sums.r;
  out[n + lane] = sums.g;
  out[2 * n + lane] = sums.b;
  out[3 * n + lane] = cost;
  if (kAdaptive) {
    out[4 * n + lane] = (float)path.s;  // every sample up to s completed
    out[5 * n + lane] = sums.l2;
  }
  segs[lane] = nsegs;
}

// Fill the shared PathParams from the launcher's arguments.
inline PathParams path_params(int wp, int seed, int sample_offset, int spp,
                              int max_depth, int rr_depth, int exhaust_black,
                              int near_zero_guard, float inv_w,
                              float inv_h) {
  PathParams p;
  p.wp = wp;
  p.seed = (uint32_t)seed;
  p.sample_offset = sample_offset;
  p.spp = spp;
  p.max_depth = max_depth;
  p.rr_depth = rr_depth;
  p.exhaust_black = exhaust_black;
  p.near_zero_guard = near_zero_guard;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  return p;
}

}  // namespace rt
