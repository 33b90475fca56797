// The closest-hit scan layout probe on Hopper: the scan's near-root chain
// over sphere slots held in shared memory, at four blocks.
//
// Replaces the TPU kernel of scripts/bench_scan_layout.py `make_kernel`
// (P4, launched at :119). Ray j = row * 128 + lane starts at
// o = (lane * 0.01, 1, (row mod 8) * 0.1), so every 8 rows repeat the TPU
// kernel's 8 x 128 rays, with the fixed direction
// d = (ox * 0.1 + 0.3, oy * -0.05, oz * 0.07 + 0.1). Each of `iters`
// trips tests every slot (cx, cy, cz, k1):
//   nb = c.d - o.d,  c_coef = (o.o - 2 c.o) + k1,  disc = nb^2 - a c_coef,
//   sq = disc >= 0 ? sqrt(|disc|) : -3e38,  q = nb - sq,
//   cand = q >= 0.001 a ? q : 3e38
// (dot products summed left to right), takes the least candidate bq, moves
// the origin by (bq, bq, -bq) * 1e-12 so every trip depends on the last,
// and adds bq to the output.
//
// Design. The slot table (float4 per slot, 8 KiB at 512 slots) sits in
// shared memory; every lane of a warp reads the same slot, a broadcast.
// On the TPU the block (512 "full", 64, 32, 8) chose an array layout; here
// it keeps only its meaning, the point where partial minima meet: each
// block of kBlock slots has its own partial minimum, folded into the
// trip's. Every instantiation runs the same slot loop, kUnroll slots a
// step (their kUnroll float4 loads issued together, then the
// candidates), so the unroll, the registers and the code size no longer
// grow with the block. A minimum of these values is exact and independent
// of order (finite candidates, 3e38 fills, never NaN; a partial minimum
// starts at +inf, above every candidate), so every block gives the same
// bits. One ray a thread: two rays a thread (one broadcast load serving
// both, their chains interleaved) leave 16 warps an SM at the
// card-filling shape and measured slower (scripts/probe_ab.py), as did a
// step of 4 slots. __launch_bounds__ asks for kMinBlocks blocks of
// kThreads an SM (32 warps), which caps a thread at 64 registers; the
// loop's kUnroll x 4 slot registers stay under it with no spill. The arithmetic
// is the TPU body's, operation for operation and in the same order, each
// rounded on its own (-fmad=false); sqrtf is correctly rounded without
// fast math, as torch.sqrt is.
//
// What bounds it on this card: the issue rate, about 25 operations a slot
// per ray and trip (a root among them), which compile to about 44 SASS
// instructions: the correctly rounded sqrtf is a MUFU, a correction and a
// slow-path branch with its reconvergence (BSSY/BSYNC, the call's moves),
// and the root's select is a branch too; device memory sees the table and
// one output per ray.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;                  // 8 x 128 threads: 32 warps
constexpr int kUnroll = 8;                     // slots a loop step
constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr float kFillQ = 0x1.c363ccp+127f;    // 3e38: no candidate
constexpr float kNegBig = -0x1.c363ccp+127f;  // -3e38: no root
constexpr float kMinT = 0x1.0624dep-10f;      // 0.001
constexpr float kStep = 0x1.197998p-40f;      // 1e-12
constexpr float kLaneX = 0x1.47ae14p-7f;      // 0.01
constexpr float kTenth = 0x1.99999ap-4f;      // 0.1
constexpr float kDirX = 0x1.333334p-2f;       // 0.3
constexpr float kDirY = -0x1.99999ap-5f;      // -0.05
constexpr float kDirZ = 0x1.1eb852p-4f;       // 0.07

struct Ray {
  float dx, dy, dz, odd, ooo, ox, oy, oz, a, min_t_a;
};

__device__ __forceinline__ void start_ray(Ray& r, int ray) {
  r.ox = (float)(ray % kLanes) * kLaneX;
  r.oy = 1.0f;
  r.oz = (float)((ray / kLanes) % kRows) * kTenth;
  r.dx = r.ox * kTenth + kDirX;
  r.dy = r.oy * kDirY;
  r.dz = r.oz * kDirZ + kTenth;
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  r.min_t_a = kMinT * r.a;
}

__device__ __forceinline__ float candidate(const float4 c, const Ray& r) {
  const float c_dot_d = c.x * r.dx + c.y * r.dy + c.z * r.dz;
  const float c_dot_o = c.x * r.ox + c.y * r.oy + c.z * r.oz;
  const float nb = c_dot_d - r.odd;
  const float c_coef = r.ooo - 2.0f * c_dot_o + c.w;
  const float disc = nb * nb - r.a * c_coef;
  const float sq = disc >= 0.0f ? sqrtf(fabsf(disc)) : kNegBig;
  const float q = nb - sq;
  return q >= r.min_t_a ? q : kFillQ;
}

template <int kBlock>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_kernel(const float4* __restrict__ sph, float* __restrict__ out,
                int n_slots, int n, int iters) {
  constexpr int kSteps = kBlock / kUnroll;  // loop steps a block
  static_assert(kBlock % kUnroll == 0, "the block holds whole steps");
  extern __shared__ float4 slots[];
  for (int j = threadIdx.x; j < n_slots; j += kThreads) slots[j] = sph[j];
  __syncthreads();
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n) return;
  Ray r;
  start_ray(r, ray);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    r.odd = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    r.ooo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    float bq = __int_as_float(0x7f800000);  // +inf
#pragma unroll 1
    for (int b = 0; b < n_slots; b += kBlock) {
      float part = __int_as_float(0x7f800000);  // the block's minimum
#pragma unroll 1
      for (int s = 0; s < kSteps; ++s) {
        const float4* at = slots + b + s * kUnroll;
        float4 c[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) c[j] = at[j];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          part = fminf(part, candidate(c[j], r));
      }
      bq = fminf(bq, part);
    }
    const float step = bq * kStep;
    r.ox = r.ox + step;
    r.oy = r.oy + step;
    r.oz = r.oz - step;
    acc = acc + bq;
  }
  out[ray] = acc;
}

template <int kBlock>
cudaError_t launch(const float4* sph, float* out, int n_slots, int n,
                   int iters, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  scan_kernel<kBlock><<<blocks, kThreads, sizeof(float4) * n_slots,
                        stream>>>(sph, out, n_slots, n, iters);
  return cudaGetLastError();
}

}  // namespace

// Launches the <block> instantiation (512, 64, 32 or 8) over n rays (rows
// of 128) and a table of n_slots rows of 4 floats (a multiple of the
// block, at most 3072: 48 KiB) on `stream`; returns the launch's
// cudaError_t (0 on success), cudaErrorInvalidValue for another block or
// table size. The caller checks shapes and devices.
extern "C" int probe_scan_launch(const float* sph, float* out, int block,
                                 int n_slots, int n, int iters,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n_slots < block || n_slots % block || n_slots > 3072)
    return (int)cudaErrorInvalidValue;
  const float4* s = reinterpret_cast<const float4*>(sph);
  cudaStream_t st = (cudaStream_t)stream;
  switch (block) {
    case 512: return (int)launch<512>(s, out, n_slots, n, iters, st);
    case 64: return (int)launch<64>(s, out, n_slots, n, iters, st);
    case 32: return (int)launch<32>(s, out, n_slots, n, iters, st);
    case 8: return (int)launch<8>(s, out, n_slots, n, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
