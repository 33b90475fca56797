// The shared-memory gather probe on Hopper: per-lane gathers from a table
// in shared memory, and their reconstruction by a one-hot matrix product
// on the tensor cores.
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
// Design of the gathers. One thread per output element; each block copies
// the whole table into dynamic shared memory (128 KiB at S = 256, W = 128:
// above the 48 KiB default, so the launcher opts in and refuses a table
// above the card's limit). The index is recomputed from the trip counter
// every trip, as the TPU kernel does, so nothing is hoisted; mod is a
// mask. Banks: kAxis0 reads column l in lane l, 32 lanes on 32 banks, no
// conflict; kAxis1 reads one word per row, a broadcast. A grid's second
// dimension holds replicas of the same output, so the same table fills
// the card.
//
// Design of the one-hot product. The TPU ran it on its matrix unit; here
// it runs on the tensor cores, one warp per 16 output elements, as
// mma.sync m16n8k16 (bf16 inputs, fp32 accumulator) over the table's
// 16-row k-tiles: A is the one-hot (16 outputs x 16 table rows a step),
// B the table's column 0 split exactly into three bf16 pieces,
// x = (hi + mid) + lo (hi the top 16 bits of x, mid those of x - hi, lo
// the rest, which fits a bf16 for every normal x of at least 2^-103), in
// B's columns 0-2, columns 3-7 zero. Each output row's one-hot has one 1,
// so each accumulated column is one exact product plus zeros, and
// (hi + mid) + lo in fp32 gives back tbl[idx][0] bit for bit; the sum with
// acc keeps the trips' order. B lives in registers, 2 a k-tile, loaded
// once a warp (no shared memory, no copy of the table). A is built per
// trip: for each of a thread's two fragment rows, the words of the k-tile
// that holds idx come from idx & 15. A warp's 16 outputs are consecutive,
// so their ones lie in two neighbouring k-tiles, the first of them the
// same for the whole warp; a switch on it picks, at compile time, which
// k-tiles get the words and which get zero, so no k-tile costs a select;
// the product still runs over every k-tile, one accumulator chain: the
// A/B (scripts/probe_ab.py) found k-tiles alternating between two
// accumulators no faster, and a wgmma.m64n8k16 form (A from registers, B
// from shared memory) slower, as it waits for every trip's MMAs. A table of more than 256 rows (none of the probe's
// cases: B would not fit the registers) keeps the scan, a compare-select-
// multiply-add over every table row per output and trip from shared
// memory.
//
// What bounds it on this card: the gathers, shared-memory loads (one
// 4-byte word per lane and trip, 32 lanes a clock per SM) and issue slots
// for the index arithmetic; the one-hot product, its tensor-core MMAs
// (kTiles m16n8k16 per 16 outputs and trip) and, beside them on the CUDA
// cores, the one-hot's words and the pieces' sums. Device memory sees the
// table (column 0 for the product) and each output once.

#include <cuda_runtime.h>

#include <cstdint>

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

// --- the one-hot product on the tensor cores -----------------------------

constexpr int kMmaThreads = 128;        // 4 warps, 16 outputs each
constexpr int kMmaMinBlocks = 8;        // 32 warps an SM: 64 registers
constexpr int kMmaMaxRows = 256;        // B of 16 k-tiles in registers
constexpr uint32_t kOneBf16 = 0x3f80u;  // bf16 1.0

// Piece p (0 hi, 1 mid, 2 lo) of x = (hi + mid) + lo, as a bf16's bits.
__device__ __forceinline__ uint32_t split_piece(float x, int p) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r = x - hi;  // exact: the bits below hi's
  const float mid = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  const float lo = r - mid;  // exact, and a bf16 (at most 8 bits)
  return __float_as_uint(p == 0 ? hi : p == 1 ? mid : lo) >> 16;
}

// One output row's one-hot at trip i: the k-tile that holds its 1, and
// this thread's two A words of that k-tile (columns 2t, 2t + 1 and
// 2t + 8, 2t + 9; the low half the first column). A dead row is zero.
struct OneHotRow {
  int tile;
  uint32_t lo, hi;
};

__device__ __forceinline__ OneHotRow onehot_row(int l, int i, int S, int t,
                                                bool live) {
  const int idx = (l + i) & (S - 1);
  const unsigned u = (unsigned)((idx & 15) - 2 * t);
  const unsigned v = u - 8u;
  return {idx >> 4, live && u < 2u ? kOneBf16 << (16u * u) : 0u,
          live && v < 2u ? kOneBf16 << (16u * v) : 0u};
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One trip's product over every k-tile, the k-tile kFirst holding the
// first rows' ones (A words `first`) and the next one the rest's
// (`next`): every other k-tile's A is zero, chosen at compile time.
template <int kTiles, int kFirst>
__device__ __forceinline__ void onehot_product(
    const uint32_t (&b)[kTiles][2], const uint32_t (&first)[4],
    const uint32_t (&next)[4], float (&d)[4]) {
  constexpr int kNext = (kFirst + 1) % kTiles;
#pragma unroll
  for (int kt = 0; kt < kTiles; ++kt) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = (kt == kFirst ? first[r] : 0u) | (kt == kNext ? next[r] : 0u);
    mma_bf16(d, a[0], a[1], a[2], a[3], b[kt][0], b[kt][1]);
  }
}

#define RT_ONEHOT_CASE(n)                                           \
  case n:                                                           \
    if constexpr (n < kTiles)                                       \
      onehot_product<kTiles, n>(b, first, next, d);                 \
    break;

// The product with the first k-tile `tile` (warp-uniform), dispatched to
// its compile-time placement of the two nonzero k-tiles.
template <int kTiles>
__device__ __forceinline__ void onehot_at(int tile,
                                          const uint32_t (&b)[kTiles][2],
                                          const uint32_t (&first)[4],
                                          const uint32_t (&next)[4],
                                          float (&d)[4]) {
  switch (tile) {
    RT_ONEHOT_CASE(0) RT_ONEHOT_CASE(1) RT_ONEHOT_CASE(2) RT_ONEHOT_CASE(3)
    RT_ONEHOT_CASE(4) RT_ONEHOT_CASE(5) RT_ONEHOT_CASE(6) RT_ONEHOT_CASE(7)
    RT_ONEHOT_CASE(8) RT_ONEHOT_CASE(9) RT_ONEHOT_CASE(10)
    RT_ONEHOT_CASE(11) RT_ONEHOT_CASE(12) RT_ONEHOT_CASE(13)
    RT_ONEHOT_CASE(14) RT_ONEHOT_CASE(15)
  }
}

#undef RT_ONEHOT_CASE

// A warp's 16 outputs are consecutive elements from e0 (a multiple of
// 16), so their lanes are consecutive from a multiple of 16 (W >= 16) or
// lie in [0, W) (W < 16): at trip i their indices are 16 consecutive
// values mod S from the warp's base, and the ones lie in the base's
// k-tile and the next.
template <int kTiles>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
    onehot_mma_kernel(const float* __restrict__ tbl, float* __restrict__ out,
                      int S, int W, int rows, int iters) {
  const int per_rep = rows * W;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int e0 = (blockIdx.x * kMmaThreads + threadIdx.x) / 32 * 16;
  if (e0 >= per_rep) return;  // the whole warp
  // B: piece g (0 hi, 1 mid, 2 lo; columns 3-7 zero) of tbl[k][0] for
  // rows k = 16 kt + 2t + {0, 1} and + {8, 9}, rows past S zero
  uint32_t b[kTiles][2];
#pragma unroll
  for (int kt = 0; kt < kTiles; ++kt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 16 * kt + 2 * t + 8 * half + j;
        if (g < 3 && k < S) word |= split_piece(tbl[(size_t)k * W], g)
                                    << (16 * j);
      }
      b[kt][half] = word;
    }
  }
  const int e_g = e0 + g, e_h = e0 + g + 8;
  const bool live_g = e_g < per_rep, live_h = e_h < per_rep;
  const int l_g = e_g & (W - 1), l_h = e_h & (W - 1);
  const int base = (e0 & (W - 1)) & ~15;  // the warp's base lane
  float acc_g = 0.0f, acc_h = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const int tile = ((base + i) & (S - 1)) >> 4;
    const OneHotRow rg = onehot_row(l_g, i, S, t, live_g);
    const OneHotRow rh = onehot_row(l_h, i, S, t, live_h);
    const bool fg = rg.tile == tile, fh = rh.tile == tile;
    const uint32_t first[4] = {fg ? rg.lo : 0u, fh ? rh.lo : 0u,
                               fg ? rg.hi : 0u, fh ? rh.hi : 0u};
    const uint32_t next[4] = {fg ? 0u : rg.lo, fh ? 0u : rh.lo,
                              fg ? 0u : rg.hi, fh ? 0u : rh.hi};
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    onehot_at<kTiles>(tile, b, first, next, d);
    // lane t = 0 holds columns 0 (hi) and 1 (mid), lane t = 1 column 2
    const float lo_g = __shfl_down_sync(0xffffffffu, d[0], 1);
    const float lo_h = __shfl_down_sync(0xffffffffu, d[2], 1);
    acc_g = acc_g + ((d[0] + d[1]) + lo_g);
    acc_h = acc_h + ((d[2] + d[3]) + lo_h);
  }
  if (t == 0) {
    float* o = out + (size_t)blockIdx.y * per_rep;
    if (live_g) o[e_g] = acc_g;
    if (live_h) o[e_h] = acc_h;
  }
}

template <int kTiles>
cudaError_t launch_onehot_mma(const float* tbl, float* out, int S, int W,
                              int rows, int reps, int iters,
                              cudaStream_t stream) {
  const int warps = (rows * W + 15) / 16;
  const dim3 grid((warps * 32 + kMmaThreads - 1) / kMmaThreads, reps);
  onehot_mma_kernel<kTiles><<<grid, kMmaThreads, 0, stream>>>(
      tbl, out, S, W, rows, iters);
  return cudaGetLastError();
}

// The one-hot product on the tensor cores for a table of at most 256 rows
// (S / 16 k-tiles, one for S < 16), else the scan.
cudaError_t launch_onehot(const float* tbl, float* out, int S, int W,
                          int rows, int reps, int iters, size_t smem,
                          cudaStream_t stream) {
  if (S > kMmaMaxRows)
    return launch<kOneHot>(tbl, out, S, W, rows, reps, iters, smem, stream);
  switch (S <= 16 ? 1 : S / 16) {
    case 1: return launch_onehot_mma<1>(tbl, out, S, W, rows, reps, iters,
                                        stream);
    case 2: return launch_onehot_mma<2>(tbl, out, S, W, rows, reps, iters,
                                        stream);
    case 4: return launch_onehot_mma<4>(tbl, out, S, W, rows, reps, iters,
                                        stream);
    case 8: return launch_onehot_mma<8>(tbl, out, S, W, rows, reps, iters,
                                        stream);
    case 16: return launch_onehot_mma<16>(tbl, out, S, W, rows, reps, iters,
                                          stream);
    default: return cudaErrorInvalidValue;
  }
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
      return (int)launch_onehot(tbl, out, S, W, rows, reps, iters, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
