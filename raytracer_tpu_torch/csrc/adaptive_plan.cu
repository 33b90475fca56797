// The adaptive render's re-plan after a chunk, over the live lanes only.
//
// Replaces, on the card, the host's full-width re-plan
// (render/megakernel.py's `accumulate_sorted`, render/adaptive_plan.py's
// `chunk_mean_stats` and `plan_adaptive`: about a hundred tensor
// operations over every pixel and two argsorts). A pixel whose interval has met the tolerance gets budget
// 0: it takes no more samples, so its sums, its chunk statistics and its
// decision never change again. Only the lanes that had budget are read,
// and their count stays on the device, where the previous plan left it.
//
// One launch of the chain after chunk k, given the previous plan's lane
// order (lane -> pixel) and its live count L (lanes [0, L) have budget,
// the rest converged earlier):
//   1. accumulate: one pass over lanes j < L. Lane j's six rows go into
//      its pixel's accumulator, the chunk's mean luminance into the
//      pixel's chunk statistics (the stratified sampler's; the sums
//      before and after the add stay in registers), its bounces into the
//      exact int64 total; then the convergence test of `plan_adaptive`,
//      in its order of float32 operations, and the pixel's sort key.
//      Lanes past L have budget 0 and zero output: skipping them changes
//      no bit. After the last chunk only the sums are kept (no re-plan).
//   2. sort the L keys: tiles of kTile keys in shared memory (bitonic),
//      then merge passes of doubling runs, each element placed by a binary
//      search of its partner run. A key is (converged, the float32 order
//      of -cost, pixel): unique, so every sort gives one order, that of
//      `plan_adaptive`'s stable argsort of where(converged, 3e38, -cost)
//      over pixel order for the live pixels, then the newly converged
//      pixels in pixel order. Passes whose runs already cover L return at
//      once; the last pass needed writes the plan.
//   3. the plan: lanes [0, L) get their pixel (order, pixel_map) and
//      budget (cs, or 0 for a converged pixel); lanes past L keep theirs,
//      so the map stays a permutation. The live extent [L_new, cs or 0]
//      that the walk reads goes to the caller's buffer.
// No kernel reads a count back to the host: each takes L from the device.
//
// Built with the port's flags (-fmad=false, no fast math): every product,
// quotient and square root rounds as in `chunk_mean_stats` and
// `plan_adaptive`, which the plain steps (render/adaptive_plan.py) run.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // the accumulate and merge passes
constexpr int kSortThreads = 1024;  // a tile's sort
constexpr int kTile = 4096;         // keys a block sorts in shared memory
constexpr int kMaxBlocks = 1056;    // the passes' grid: 8 blocks an SM
constexpr float kOneThird = 0x1.555556p-2f;  // float32(1/3)
constexpr float kZ975 = 0x1.f5c29p+0f;       // float32(1.96)
constexpr float kMinChunks = 0x1.8p+1f;      // 3: chunks of an interval

struct Chain {
  const float* out;  // (6, n) the chunk's lane-order sums (add only)
  const int* segs;   // (n,) the chunk's bounces per lane
  float* acc;        // (6, n) pixel order: rgb, cost, n, sum of lum^2
  float* stats;      // (3, n) pixel order: n_c, sum m, sum m^2; or null
  unsigned long long* segments;  // the exact total, int64
  int* order;        // (n,) lane -> pixel index
  int* pixel_map;    // (n, 2) lane -> [px, py]
  int* budget;       // (n,) lane -> samples
  const int* live_in;  // lanes with budget (L), or null: every lane
  int* live_out;     // the re-plan's live count (zero before), or null
  unsigned long long* keys;  // (2, n) the sort's two buffers
  const float* t975;  // the Student-t quantiles by chunk count
  int n_t975;
  unsigned long long* counts;  // plan_lanes, plan_slots; or null
  int* extent;       // (2,) the walk's live extent
  int n, width, add, add_stats, cs, pixel_bits;
  float tol, min_n, abs_floor;
};

__device__ __forceinline__ int lanes_of(const Chain& c) {
  return c.live_in != nullptr ? *c.live_in : c.n;
}

// torch.clamp_min and torch.minimum: NaN goes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// plan_adaptive's test of one pixel: its sums a and chunk statistics st
__device__ __forceinline__ bool converged(const Chain& c, const float* a,
                                          const float* st) {
  const float nn = a[4];
  const float n_safe = clamp_min(nn, 1.0f);
  const float mean = (((a[0] + a[1]) + a[2]) * kOneThird) / n_safe;
  const float var = clamp_min(a[5] / n_safe - mean * mean, 0.0f);
  float ci = kZ975 * sqrtf(var / n_safe);
  if (c.stats != nullptr && st[0] >= kMinChunks) {
    const float nc = st[0];
    const float nc_safe = clamp_min(nc, 1.0f);
    const float m_mean = st[1] / nc_safe;
    const float s2 =
        (clamp_min(st[2] / nc_safe - m_mean * m_mean, 0.0f) * nc_safe) /
        clamp_min(nc - 1.0f, 1.0f);
    const int last = c.n_t975 - 1;
    const int at = nc >= (float)last ? last : (int)nc;
    const float ci_c = c.t975[at] * sqrtf(s2 / nc_safe);
    ci = minimum(ci, ci_c);
  }
  return nn >= c.min_n && ci <= c.tol * (mean + c.abs_floor);
}

// The sort key of pixel p: converged above every live key, then the
// float32 order of -cost (-0 taken as +0, as a comparison sees it), then
// the pixel.
__device__ __forceinline__ unsigned long long sort_key(const Chain& c,
                                                       bool conv, float cost,
                                                       int p) {
  const int bits = c.pixel_bits;
  if (conv) return (1ull << (32 + bits)) | (unsigned long long)p;
  uint32_t b = __float_as_uint(-cost + 0.0f);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << bits) | (unsigned long long)p;
}

// Lane `lane` of the plan from its sorted key.
__device__ __forceinline__ void emit(const Chain& c, int lane,
                                     unsigned long long key) {
  const int bits = c.pixel_bits;
  const int p = (int)(key & ((1ull << bits) - 1ull));
  c.order[lane] = p;
  c.pixel_map[2 * lane] = p % c.width;
  c.pixel_map[2 * lane + 1] = p / c.width;
  c.budget[lane] = (key >> (32 + bits)) != 0ull ? 0 : c.cs;
}

// Step 1: lanes j < L.
__global__ void __launch_bounds__(kThreads) accumulate_kernel(const Chain c) {
  __shared__ unsigned long long s_segs;
  __shared__ unsigned int s_live;
  if (threadIdx.x == 0) {
    s_segs = 0ull;
    s_live = 0u;
  }
  __syncthreads();
  const int lanes = lanes_of(c);
  const int n = c.n;
  long long my_segs = 0;
  unsigned int my_live = 0u;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < lanes;
       j += gridDim.x * blockDim.x) {
    const int p = c.order[j];
    float a[6];
    for (int r = 0; r < 6; ++r) a[r] = c.acc[r * n + p];
    const float lsum_prev = (a[0] + a[1]) + a[2];
    const float n_prev = a[4];
    if (c.add) {
      for (int r = 0; r < 6; ++r) {
        a[r] = a[r] + c.out[r * n + j];
        c.acc[r * n + p] = a[r];
      }
    }
    my_segs += c.segs[j];
    float st[3] = {0.0f, 0.0f, 0.0f};
    if (c.stats != nullptr) {
      for (int r = 0; r < 3; ++r) st[r] = c.stats[r * n + p];
      // chunk_mean_stats: a pixel that took no sample adds nothing
      const float dn = a[4] - n_prev;
      if (c.add_stats && dn > 0.0f) {
        const float m = ((((a[0] + a[1]) + a[2]) - lsum_prev) * kOneThird) /
                        clamp_min(dn, 1.0f);
        st[0] = st[0] + 1.0f;
        st[1] = st[1] + m;
        st[2] = st[2] + m * m;
        for (int r = 0; r < 3; ++r) c.stats[r * n + p] = st[r];
      }
    }
    if (c.live_out != nullptr) {
      const bool conv = converged(c, a, st);
      c.keys[j] = sort_key(c, conv, a[3], p);
      my_live += conv ? 0u : 1u;
    }
  }
  atomicAdd(&s_segs, (unsigned long long)my_segs);
  atomicAdd(&s_live, my_live);
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (s_segs != 0ull) atomicAdd(c.segments, s_segs);
  if (c.live_out == nullptr) return;
  if (s_live != 0u) atomicAdd(c.live_out, (int)s_live);
  if (blockIdx.x == 0 && c.counts != nullptr) {
    atomicAdd(&c.counts[0], (unsigned long long)lanes);
    atomicAdd(&c.counts[1], (unsigned long long)n);
  }
}

// Step 2a: each block sorts its tile of the L keys (padded to a power of
// two with keys above every real one) in place, or, where one tile holds
// them all, writes the plan. Block 0 first writes the walk's live extent
// from the count step 1 finished.
__global__ void __launch_bounds__(kSortThreads) sort_tiles(const Chain c) {
  __shared__ unsigned long long s[kTile];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int live = *c.live_out;
    c.extent[0] = live;
    c.extent[1] = live > 0 ? c.cs : 0;
  }
  const int lanes = lanes_of(c);
  const int base = blockIdx.x * kTile;
  if (base >= lanes) return;
  const int len = lanes - base < kTile ? lanes - base : kTile;
  int size = 1;
  while (size < len) size <<= 1;
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    s[i] = i < len ? c.keys[base + i] : ~0ull;
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int i = threadIdx.x; i < size / 2; i += blockDim.x) {
        const int lo = ((i & ~(h - 1)) << 1) | (i & (h - 1));
        const int hi = lo + h;
        const unsigned long long x = s[lo], y = s[hi];
        if ((x > y) == ((lo & k) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  const bool last = lanes <= kTile;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    if (last)
      emit(c, base + i, s[i]);
    else
      c.keys[base + i] = s[i];
  }
}

// Step 2b: merge runs of `width` sorted keys of buffer (pass & 1) into
// runs of twice that in the other buffer; the pass after which one run
// holds all L keys writes the plan instead.
__global__ void __launch_bounds__(kThreads) merge_pass(const Chain c,
                                                       int width, int pass) {
  const int lanes = lanes_of(c);
  if (lanes <= width) return;
  const unsigned long long* src = c.keys + (size_t)(pass & 1) * c.n;
  unsigned long long* dst = c.keys + (size_t)((pass + 1) & 1) * c.n;
  const bool last = (long long)lanes <= 2ll * width;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += gridDim.x * blockDim.x) {
    const unsigned long long x = src[i];
    const int run = i / width;
    const int other = (run ^ 1) * width;
    int rank = 0;
    if (other < lanes) {
      // the partner run's keys below x (keys are unique)
      int lo = other;
      int hi = (long long)other + width < lanes ? other + width : lanes;
      while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (src[mid] < x)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank = lo - other;
    }
    const int at = (run & ~1) * width + (i - run * width) + rank;
    if (last)
      emit(c, at, x);
    else
      dst[at] = x;
  }
}

int blocks_for(long long items, int threads) {
  const long long b = (items + threads - 1) / threads;
  return (int)(b < kMaxBlocks ? (b < 1 ? 1 : b) : kMaxBlocks);
}

}  // namespace

// One re-plan (or, with live_out null, the last chunk's accumulation)
// on `stream`. out (6, n) float32 lane order, or null where acc already
// holds the chunk (the profile chunk, in identity order); segs (n,) int32;
// acc (6, n) and stats (3, n, or null) float32 pixel order; segments one
// int64; order (n,), pixel_map (n, 2), budget (n,) int32; live_in one int
// (null: n lanes), live_out one zeroed int (null: no re-plan); keys 2n
// uint64; t975 n_t975 float32; counts two uint64 (or null); extent two
// ints. add_stats: add this chunk to the chunk statistics. Returns the
// cudaError_t of the launches.
extern "C" int adaptive_plan_launch(
    const float* out, const int* segs, float* acc, float* stats,
    long long* segments, int* order, int* pixel_map, int* budget,
    const int* live_in, int* live_out, unsigned long long* keys,
    const float* t975, int n_t975, unsigned long long* counts, int* extent,
    int n, int width, int add_stats, int cs, int pixel_bits, float tol,
    float min_n, float abs_floor, void* stream) {
  if (n < 1) return (int)cudaSuccess;
  if (width < 1 || pixel_bits < 1 || 33 + pixel_bits > 64 ||
      (n - 1) >> pixel_bits != 0 || segs == nullptr || acc == nullptr ||
      segments == nullptr || order == nullptr || n_t975 < 1 ||
      (live_out != nullptr &&
       (pixel_map == nullptr || budget == nullptr || keys == nullptr ||
        t975 == nullptr || extent == nullptr)))
    return (int)cudaErrorInvalidValue;
  Chain c;
  c.out = out;
  c.segs = segs;
  c.acc = acc;
  c.stats = stats;
  c.segments = reinterpret_cast<unsigned long long*>(segments);
  c.order = order;
  c.pixel_map = pixel_map;
  c.budget = budget;
  c.live_in = live_in;
  c.live_out = live_out;
  c.keys = keys;
  c.t975 = t975;
  c.n_t975 = n_t975;
  c.counts = counts;
  c.extent = extent;
  c.n = n;
  c.width = width;
  c.add = out != nullptr;
  c.add_stats = add_stats;
  c.cs = cs;
  c.pixel_bits = pixel_bits;
  c.tol = tol;
  c.min_n = min_n;
  c.abs_floor = abs_floor;
  cudaStream_t st = (cudaStream_t)stream;
  accumulate_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(c);
  if (live_out != nullptr) {
    sort_tiles<<<(n + kTile - 1) / kTile, kSortThreads, 0, st>>>(c);
    int pass = 0;
    for (long long width_k = kTile; width_k < n; width_k *= 2, ++pass)
      merge_pass<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
          c, (int)width_k, pass);
  }
  return (int)cudaGetLastError();
}
