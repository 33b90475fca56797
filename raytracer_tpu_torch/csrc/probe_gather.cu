// The shared-memory gather probe on Hopper: per-lane gathers from a table
// in shared memory, and their reconstruction by a one-hot scan.
//
// Replaces the TPU kernels of scripts/probe_mosaic_gather.py: `run(mode)`
// (P1, launched at :89) and `run_sameshape(shape, axis)` (P1b, :133). The
// table tbl is S rows of W floats (S and W powers of two); every output
// row r of every replica b is a sum over i < iters, in order, of
//   kAxis0   tbl[(l + i) mod S][l]           (P1 take_along_axis, P1b
//                                             axis 0: lane l reads
//                                             column l)
//   kAxis1   tbl[r][(r + i) mod W]            (P1b axis 1: every lane of
//                                             row r reads one element)
//   kOneHot  sum over s < S of tbl[s][0] * [s == (l + i) mod S]
//                                            (P1 onehot_matmul: the
//                                             one-hot product the TPU
//                                             kernel runs on its matrix
//                                             unit, column 0 only)
// The products with a 0/1 one-hot are exact and all but one are +0, so
// kOneHot is bitwise the gather of column 0, whatever the order of its sum.
//
// Design. One thread per output element; each block copies the whole table
// into dynamic shared memory (128 KiB at S = 256, W = 128: above the 48 KiB
// default, so the launcher opts in and refuses a table above the card's
// limit). The index is recomputed from the trip counter every trip, as the
// TPU kernel does, so nothing is hoisted; mod is a mask. Banks: kAxis0
// reads column l in lane l, 32 lanes on 32 banks, no conflict; kAxis1 reads
// one word per row, a broadcast; kOneHot reads tbl[s][0] in every lane, a
// broadcast (a direct read of tbl[idx][0] by 32 lanes would be a 32-way
// conflict). A grid's second dimension holds replicas of the same output,
// so the same table fills the card.
//
// What bounds it on this card: shared-memory loads (one 4-byte word per
// lane and trip, 32 lanes a clock per SM) and issue slots for the index
// arithmetic; kOneHot is S compare-select-multiply-add steps per trip.
// Device memory sees the table once per block and each output once.

#include <cuda_runtime.h>

namespace {

constexpr int kAxis0 = 0;
constexpr int kAxis1 = 1;
constexpr int kOneHot = 2;
constexpr int kThreads = 1024;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ tbl, float* __restrict__ out,
                  int S, int W, int rows, int iters) {
  extern __shared__ float smem[];
  const int cells = S * W;
  for (int j = threadIdx.x; j < cells; j += kThreads) smem[j] = tbl[j];
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * W) return;
  const int r = e / W, l = e % W;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float g;
    if (kMode == kAxis0) {
      g = smem[((l + i) & (S - 1)) * W + l];
    } else if (kMode == kAxis1) {
      g = smem[r * W + ((r + i) & (W - 1))];
    } else {
      const int idx = (l + i) & (S - 1);
      g = 0.0f;
      for (int s = 0; s < S; ++s)
        g = g + smem[s * W] * (s == idx ? 1.0f : 0.0f);
    }
    acc = acc + g;
  }
  out[(size_t)blockIdx.y * rows * W + e] = acc;
}

template <int kMode>
cudaError_t launch(const float* tbl, float* out, int S, int W, int rows,
                   int reps, int iters, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows * W + kThreads - 1) / kThreads, reps);
  gather_kernel<kMode><<<grid, kThreads, smem, stream>>>(tbl, out, S, W,
                                                         rows, iters);
  return cudaGetLastError();
}

}  // namespace

// Largest table, in bytes, a block of this kernel may hold on the current
// device (its opt-in shared memory), or -1 with the error unread.
extern "C" int probe_gather_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return limit;
}

// Launches mode 0 (axis 0), 1 (axis 1) or 2 (one-hot) over `reps` replicas
// of `rows` x W outputs on `stream`; returns the launch's cudaError_t (0 on
// success), cudaErrorInvalidValue for another mode, a table whose sides are
// not powers of two or above the device's shared memory, more axis-1 rows
// than the table has, or more replicas than a grid holds. The caller
// checks shapes and devices.
extern "C" int probe_gather_launch(const float* tbl, float* out, int mode,
                                   int S, int W, int rows, int reps,
                                   int iters, void* stream) {
  if (rows <= 0 || reps <= 0) return 0;
  if (S <= 0 || W <= 0 || (S & (S - 1)) || (W & (W - 1)) ||
      (mode == kAxis1 && rows > S) || reps > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)S * W;
  const int limit = probe_gather_smem_limit();
  if (limit < 0 || smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kAxis0:
      return (int)launch<kAxis0>(tbl, out, S, W, rows, reps, iters, smem, st);
    case kAxis1:
      return (int)launch<kAxis1>(tbl, out, S, W, rows, reps, iters, smem, st);
    case kOneHot:
      return (int)launch<kOneHot>(tbl, out, S, W, rows, reps, iters, smem,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
