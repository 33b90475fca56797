// The closest-hit scan layout probe on Hopper: the scan's near-root chain
// over sphere slots held in shared memory, at four unroll blocks.
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
// Design. One thread per ray; the slot table (float4 per slot, 8 KiB at
// 512 slots) sits in shared memory and every lane of a warp reads the same
// slot, a broadcast. kBlock slots form one unrolled inner loop with its own
// partial minimum, then a minimum over the blocks: the TPU's question of
// array layout (one (512, 128) chain against (8, 128) strips) becomes one
// of unroll and registers. The inner loop unrolls fully up to kMaxUnroll
// slots; the 512-slot block ("full", the TPU's one chain over every slot)
// is one running minimum over the table, unrolled kMaxUnroll slots at a
// time. A minimum is exact, so every block gives the same values. The
// arithmetic is the TPU body's, operation for operation and in the same
// order, each rounded on its own (-fmad=false); sqrtf is correctly rounded
// without fast math, as torch.sqrt is.
//
// What bounds it on this card: the FP32 issue rate, about 25 operations a
// slot per ray and trip (a root among them); device memory sees the table
// and one output per ray. The compiler hoists a block's shared-memory
// loads ahead of its arithmetic, four registers a slot: an unroll of 64
// slots exceeds the 255 registers a thread may hold and spills, which is
// part of the answer the probe gives. Unrolled whole, the 512-slot block
// spilled 9 KB and took minutes of ptxas, so its unroll stops at 64 too.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr int kMaxUnroll = 64;                 // slots unrolled at most
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
__device__ __forceinline__ float block_min(const float4* slots, int b,
                                           const Ray& r) {
  constexpr int kUnroll = kBlock < kMaxUnroll ? kBlock : kMaxUnroll;
  float m = candidate(slots[b], r);
#pragma unroll
  for (int j = 1; j < kUnroll; ++j) m = fminf(m, candidate(slots[b + j], r));
#pragma unroll 1
  for (int c = b + kUnroll; c < b + kBlock; c += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) m = fminf(m, candidate(slots[c + j], r));
  }
  return m;
}

template <int kBlock>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float4* __restrict__ sph, float* __restrict__ out,
                int n_slots, int n, int iters) {
  extern __shared__ float4 slots[];
  for (int j = threadIdx.x; j < n_slots; j += kThreads) slots[j] = sph[j];
  __syncthreads();
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n) return;
  Ray r;
  r.ox = (float)(ray % kLanes) * kLaneX;
  r.oy = 1.0f;
  r.oz = (float)((ray / kLanes) % kRows) * kTenth;
  r.dx = r.ox * kTenth + kDirX;
  r.dy = r.oy * kDirY;
  r.dz = r.oz * kDirZ + kTenth;
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  r.min_t_a = kMinT * r.a;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    r.odd = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    r.ooo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    float bq = block_min<kBlock>(slots, 0, r);
    for (int b = kBlock; b < n_slots; b += kBlock)
      bq = fminf(bq, block_min<kBlock>(slots, b, r));
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
