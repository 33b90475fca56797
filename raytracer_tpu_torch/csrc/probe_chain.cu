// The independent-chain issue-rate probe on Hopper, float32 and bf16.
//
// Replaces the TPU kernels of scripts/bench_bf16_vpu.py `make_kernel`
// (P3, launched at :61) and scripts/roofline.py `vpu_ceiling` (P2, :81,
// the same function as P3's float32 kernel). For every element e of
// x (CHAINS, n) and each chain c, acc_c = x[c][e] + c; then `iters` times,
// for each chain, OPS times v = v * x[c][e] + x[(c + k + 1) % CHAINS][e];
// out[e] = acc_0 + acc_1 + ... + acc_7, summed in that order.
//
// Design. One thread per element (float) or per two elements
// (__nv_bfloat162, the packed type the card issues in one instruction).
// The eight chains and the eight inputs live in registers, so the loop
// is nothing but products and sums: eight independent chains hide the
// latency of each. Every product and every sum rounds on its own (the
// build's -fmad=false; __hmul2 and __hadd2 for bf16, never a fused
// multiply-add), as the TPU kernel and the plain version round them.
// `iters` and n are run-time arguments: the TPU's 16 x 128 elements are
// 16 warps, a latency measurement on a 132-SM card; a count that puts
// several blocks on every SM measures the issue rate.
//
// What bounds it on this card: the FP32 (bf16) issue rate: one
// instruction per lane per clock, 2 x CHAINS x OPS per element per trip;
// device memory sees 9 values per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kOps = 16;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_int(int c);

__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ float add(float a, float b) { return a + b; }
template <>
__device__ __forceinline__ float from_int<float>(int c) {
  return (float)c;
}

__device__ __forceinline__ __nv_bfloat162 mul(__nv_bfloat162 a,
                                              __nv_bfloat162 b) {
  return __hmul2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a,
                                              __nv_bfloat162 b) {
  return __hadd2(a, b);
}
template <>
__device__ __forceinline__ __nv_bfloat162 from_int<__nv_bfloat162>(int c) {
  return __float2bfloat162_rn((float)c);  // exact for 0..7
}

// x: kChains rows of n values of T (n counted in T); out: n values of T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                 int iters) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  T xs[kChains], acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) xs[c] = x[(size_t)c * n + e];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = add(xs[c], from_int<T>(c));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      T v = acc[c];
#pragma unroll
      for (int k = 0; k < kOps; ++k)
        v = add(mul(v, xs[c]), xs[(c + k + 1) % kChains]);
      acc[c] = v;
    }
  }
  T sum = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) sum = add(sum, acc[c]);
  out[e] = sum;
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n, int iters,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  chain_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, iters);
  return cudaGetLastError();
}

}  // namespace

// Launches the chain over `elems` elements per chain (x is kChains rows of
// `elems`, out one row) on `stream`: float32 when bf16 is 0, else bf16
// (elems even, taken in pairs). Returns the launch's cudaError_t (0 on
// success); the caller checks shapes, types and devices.
extern "C" int probe_chain_launch(const void* x, void* out, int bf16,
                                  int elems, int iters, void* stream) {
  if (elems <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (elems % 2) return (int)cudaErrorInvalidValue;
    return (int)launch<__nv_bfloat162>(x, out, elems / 2, iters, st);
  }
  return (int)launch<float>(x, out, elems, iters, st);
}
