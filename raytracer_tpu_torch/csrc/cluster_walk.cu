// The gathered cluster walk on Hopper: one spp chunk for every lane of a
// lane->pixel map.
//
// Replaces the cluster-walk variants of the TPU kernel
// raytracer_tpu/render/pallas_kernel.py `_make_kernel(...).kernel`
// (launched by `_render_chunk_impl`) in its production configuration:
// kd partition with box bounds, one cluster per walk step, packed visit
// key, fused bounce-done test. Two template parameters give its four
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
// Both sit in the loop every lane runs, so they are compile-time: the
// <false, false> instantiation carries no trace of either.
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
// Numerics follow the plain PyTorch version
// (raytracer_tpu_torch/render/cluster_walk.py) operation for operation:
// build with -fmad=false and without --use_fast_math. Constants are the
// float32 roundings of the JAX package's Python doubles, as hex literals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Params {
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
  int wp;                // image width padded to 128: the RNG's row stride
  uint32_t seed;
  int sample_offset, spp, max_depth, rr_depth;
  int exhaust_black, near_zero_guard;
  float inv_w, inv_h;    // float32(1/W), float32(1/H), rounded on the host
};

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

// random point in the unit ball; the cube root is exp(log(u)/3)
__device__ __forceinline__ void unit_sphere(uint32_t pix, uint32_t ctr,
                                            uint32_t salt, float& x, float& y,
                                            float& z) {
  float hx = u01(pix, ctr, salt) * 2.0f - 1.0f;
  float phi = u01(pix, ctr, salt + 1) * kTwoPi;
  float u = u01(pix, ctr, salt + 2);
  float r = expf(logf(fmaxf(u, kUEps)) * kOneThird);
  float s = sqrtf(fmaxf(1.0f - hx * hx, 0.0f));
  x = r * s * sinf(phi);
  y = r * s * cosf(phi);
  z = r * hx;
}

// nearest root q = t*|d|^2 with t >= MIN_T (near root, else far root),
// kFillQ when there is none. A negative discriminant poisons the root
// to -3e38, never NaN.
__device__ __forceinline__ float exact_q(const float* c, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float a, float o_dot_d,
                                         float o_dot_o, float min_t_a) {
  float cdd = dot3(c[0], c[1], c[2], dx, dy, dz);
  float cdo = dot3(c[0], c[1], c[2], ox, oy, oz);
  float nb = cdd - o_dot_d;
  float cc = o_dot_o - 2.0f * cdo + c[3];
  float ds = nb * nb - a * cc;
  float sq = ds >= 0.0f ? sqrtf(fabsf(ds)) : kNegBig;
  float qn = nb - sq;
  float q = qn >= min_t_a ? qn : nb + sq;
  return q >= min_t_a ? q : kFillQ;
}

__device__ __forceinline__ float key_floor(float key) {
  return __int_as_float(__float_as_int(key) & ~127);
}

// direction reciprocal clamped away from zero: no slab product reaches inf
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d >= 0.0f ? fmaxf(d, kUEps) : fminf(d, -kUEps));
}

// camera ray of absolute sample index s_abs, whose counter block starts
// at s_abs * dps
template <bool kStratified>
__device__ __forceinline__ void gen_ray(const float* cam, const Params& p,
                                        uint32_t s_abs, uint32_t dps,
                                        float px, float py, uint32_t pix,
                                        float& ox, float& oy, float& oz,
                                        float& dx, float& dy, float& dz) {
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
  ox = cam[0] + (cam[12] * rdx + cam[15] * rdy);
  oy = cam[1] + (cam[13] * rdx + cam[16] * rdy);
  oz = cam[2] + (cam[14] * rdx + cam[17] * rdy);
  dx = cam[3] + st_s * cam[6] + st_t * cam[9] - ox;
  dy = cam[4] + st_s * cam[7] + st_t * cam[10] - oy;
  dz = cam[5] + st_s * cam[8] + st_t * cam[11] - oz;
}

__host__ __device__ constexpr int smem_floats(int n_global, int k, int group,
                                              int slots) {
  return 20 + 4 * n_global + 6 * k + 4 * k * group + 11 * slots;
}

template <bool kAdaptive, bool kStratified>
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

  const int ipx = p.pixel_map[2 * lane], ipy = p.pixel_map[2 * lane + 1];
  const float px = (float)ipx, py = (float)ipy;
  const uint32_t gid = (uint32_t)ipy * (uint32_t)p.wp + (uint32_t)ipx;
  const uint32_t pix = lowbias32(gid ^ p.seed);
  const uint32_t dps = 4u + (uint32_t)p.max_depth * kDrawsPerBounce;

  // samples this lane takes: its own budget, else the chunk's spp
  int limit = p.spp;
  if (kAdaptive) {
    if (p.budget != nullptr) limit = p.budget[lane];
    if (limit <= 0) {
      // a converged pixel: dead at launch, all sums zero
      for (int c = 0; c < 6; ++c) p.out[c * p.n + lane] = 0.0f;
      p.segs[lane] = 0;
      return;
    }
  }

  int s = 0, i = 0;
  float ox, oy, oz, dx, dy, dz;
  gen_ray<kStratified>(s_cam, p, (uint32_t)p.sample_offset, dps, px, py, pix,
                       ox, oy, oz, dx, dy, dz);
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  float bq = kFillQ, kl = kNegBig;  // best q, visited cursor (packed key)
  int bs = 0;                       // winner slot
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, cost = 0.0f;
  float acc_l2 = 0.0f;  // adaptive: sum of squared sample luminances
  int segs = 0;

  for (;;) {
    cost += 1.0f;
    const uint32_t ctr = (uint32_t)(p.sample_offset + s) * dps + 4u +
                         (uint32_t)i * kDrawsPerBounce;
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
    float best_t = bq * inv_a;
    const bool hit = best_t < kQCut;
    float udx = dx, udy = dy, udz = dz;
    normalize3(udx, udy, udz);
    float con_r = 0.0f, con_g = 0.0f, con_b = 0.0f;
    bool scat = false;
    float hpx = 0.0f, hpy = 0.0f, hpz = 0.0f;
    float ndx = 0.0f, ndy = 0.0f, ndz = 0.0f;
    if (!hit) {
      // sky, with the throughput before this bounce
      const float sky_t = 0.5f * (udy + 1.0f);
      con_r = cr * (1.0f - 0.5f * sky_t);
      con_g = cg * (1.0f - kSkyG * sky_t);
      con_b = cb;
    } else {
      hpx = ox + best_t * dx;
      hpy = oy + best_t * dy;
      hpz = oz + best_t * dz;
      float nx = (hpx - w[0]) * w[3];
      float ny = (hpy - w[1]) * w[3];
      float nz = (hpz - w[2]) * w[3];
      const bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      nx = nx * sgn;
      ny = ny * sgn;
      nz = nz * sgn;
      const float mat = w[4];
      if (mat < 0.5f) {  // diffuse
        float uvx, uvy, uvz;
        if (kStratified && i == 0) {
          // first bounce: (hx, phi) on the unit sphere, already unit
          const uint32_t s_u = (uint32_t)(p.sample_offset + s);
          const float b_hx =
              r2_fixed(pix, kRotBounce0, 0, s_u, kAB0Fix0) * 2.0f - 1.0f;
          const float b_phi =
              r2_fixed(pix, kRotBounce0, 1, s_u, kAB0Fix1) * kTwoPi;
          const float b_s = sqrtf(fmaxf(1.0f - b_hx * b_hx, 0.0f));
          uvx = b_s * sinf(b_phi);
          uvy = b_s * cosf(b_phi);
          uvz = b_hx;
        } else {
          unit_sphere(pix, ctr, 0, uvx, uvy, uvz);
          normalize3(uvx, uvy, uvz);
        }
        ndx = nx + uvx;
        ndy = ny + uvy;
        ndz = nz + uvz;
        if (p.near_zero_guard && fabsf(ndx) < kNearZero &&
            fabsf(ndy) < kNearZero && fabsf(ndz) < kNearZero) {
          ndx = nx;
          ndy = ny;
          ndz = nz;
        }
        scat = true;
      } else if (mat < 1.5f) {  // metal: reflect + fuzz
        float usx, usy, usz;
        unit_sphere(pix, ctr, 3, usx, usy, usz);
        const float d_dot_n = dot3(dx, dy, dz, nx, ny, nz);
        const float fuzz = w[8];
        ndx = dx - 2.0f * d_dot_n * nx + fuzz * usx;
        ndy = dy - 2.0f * d_dot_n * ny + fuzz * usy;
        ndz = dz - 2.0f * d_dot_n * nz + fuzz * usz;
        scat = dot3(nx, ny, nz, ndx, ndy, ndz) > 0.0f;
      } else if (mat < 2.5f) {  // glass: Snell + TIR + Schlick roll
        const float refr = w[9];
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
            (kStratified && i == 0)
                ? r2_fixed(pix, kRotBounce0, 2,
                           (uint32_t)(p.sample_offset + s), kAB0Fix2)
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
        cr = cr * w[5];
        cg = cg * w[6];
        cb = cb * w[7];
      }
    }
    if (p.rr_depth > 0 && i >= p.rr_depth) {
      // survive with p = max(throughput) in [0.05, 1], reweighted by 1/p
      const float p_surv = fminf(fmaxf(fmaxf(cr, fmaxf(cg, cb)), kRRMin), 1.0f);
      const bool survive = u01(pix, ctr, 7) < p_surv;
      if (survive && scat) {
        const float boost = 1.0f / p_surv;
        cr = cr * boost;
        cg = cg * boost;
        cb = cb * boost;
      }
      scat = scat && survive;
    }
    const bool exhausted = scat && i >= p.max_depth - 1;
    if (exhausted && !p.exhaust_black) {
      con_r = cr;
      con_g = cg;
      con_b = cb;
    }
    acc_r = acc_r + con_r;
    acc_g = acc_g + con_g;
    acc_b = acc_b + con_b;
    if (kAdaptive) {
      // the sample's luminance: zero unless the path ended with light
      const float lum = (con_r + con_g + con_b) * kOneThird;
      acc_l2 = acc_l2 + lum * lum;
    }

    if (scat && !exhausted) {
      ox = hpx;
      oy = hpy;
      oz = hpz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
      ++i;
    } else {
      // the path ended: regenerate the lane's next sample, if any
      ++s;
      if (s >= limit) break;
      gen_ray<kStratified>(s_cam, p, (uint32_t)(p.sample_offset + s), dps, px,
                           py, pix, ox, oy, oz, dx, dy, dz);
      cr = cg = cb = 1.0f;
      i = 0;
    }
    bq = kFillQ;
    bs = 0;
    kl = kNegBig;
  }

  p.out[lane] = acc_r;
  p.out[p.n + lane] = acc_g;
  p.out[2 * p.n + lane] = acc_b;
  p.out[3 * p.n + lane] = cost;
  if (kAdaptive) {
    p.out[4 * p.n + lane] = (float)s;  // every sample up to s completed
    p.out[5 * p.n + lane] = acc_l2;
  }
  p.segs[lane] = segs;
}

template <bool kAdaptive, bool kStratified>
cudaError_t launch(const Params& p, int blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_walk_kernel<kAdaptive, kStratified>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cluster_walk_kernel<kAdaptive, kStratified>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the walk's <adaptive, stratified> instantiation on `stream`;
// returns the launch's cudaError_t (0 on success). Tables, map and budget
// (null without one) are device pointers; the caller checks shapes.
extern "C" int cluster_walk_launch(
    const float* camera, const float* globals, const float* bounds,
    const float* members, const float* winner, const int* pixel_map,
    const int* budget, float* out, int* segs, int adaptive, int stratified,
    int n, int n_global, int k, int group, int wp,
    int seed, int sample_offset, int spp, int max_depth, int rr_depth,
    int exhaust_black, int near_zero_guard, float inv_w, float inv_h,
    void* stream) {
  if (n <= 0) return 0;
  Params p;
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
  const size_t smem =
      sizeof(float) * (size_t)smem_floats(n_global, k, group, p.slots);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (adaptive)
    return (int)(stratified ? launch<true, true>(p, blocks, smem, st)
                            : launch<true, false>(p, blocks, smem, st));
  return (int)(stratified ? launch<false, true>(p, blocks, smem, st)
                          : launch<false, false>(p, blocks, smem, st));
}
