// GRR contraction: execute a compiled gather-route-reduce plan.
//
// Replaces the two Pallas kernels of photon_ml_tpu/ops/grr_kernel.py:
//   grr_contract_kernel_dense (B2)  -> grr_contract_dense_launch
//   grr_contract_kernel       (B3)  -> grr_contract_launch
// Both run the plan that photon_ml_torch/data/grr.py builds (the same plan
// the JAX package builds): per supertile t of 128 x 128 slots, int8 planes
// g1, g2, g3 and float values vals; the table as windows of 128 x 128.
//
// What one output slot computes (the three lane gathers of the TPU kernel,
// composed into one chain of indexed reads):
//   a = g3[r,l];  b = g2[a,r];  x3 = window[b, g1[b,a]];  c = x3 * vals[r,l]
//   partial[j,l] = sum_{q < cap} c[q * (128 / cap) + j, l]
// B2 (dense grid): tiles are gw-major over the full (gw x ow_p) grid, tile
//   t = gw * n_ow_p + ow, and out[ow] = sum over gw of the tile partials.
// B3: supertiles sorted by (ow, gw); out[ow] = sum of its run's partials.
//
// Bound: bytes.  Every slot streams 7 bytes (vals f32 + g1/g2/g3 i8) once;
// the windows and the output are small beside that.  The arithmetic is one
// fma a slot.  The table gathers are 4-byte reads scattered within one
// 64 KB window, which the 50 MB L2 holds.
//
// Design (simple first): blocks of 256 threads over (output window, share
// of its tiles).  A block walks its tiles in order (B2: its share of gw =
// 0..n_gw-1; B3: its share of the window's run of supertiles, found by
// binary search in the sorted ow_of_st).  The wrapper cuts a window's walk
// into shares only when windows are few against the SMs (the gradient
// direction has ~50 windows of 55 tiles); a second kernel then sums the
// shares in order.  For each tile a block stages g1 and g2 in shared
// memory (g2 transposed, rows padded to 132 bytes, so that both the
// transposing stores and the lookups g2[a,r] for fixed r spread over the
// banks), then each thread walks its (j, l) outputs: lane l = threadIdx %
// 128, rows j = threadIdx / 128 + 2i.  g3 and vals load coalesced along l;
// the window is read through __ldg.  Each thread keeps its outputs in
// registers across tiles and writes them once.  Sums run in a fixed order
// with no atomics (each tile's partial, then tile after tile, then share
// after share): results are deterministic.  Lane indices are 0..127 by
// construction; they are masked to 7 bits so that a corrupt plan cannot
// read outside its tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kSlots = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kTile;
constexpr int kG2Stride = kTile + 4;
constexpr int kDenseB = 4;  // tiles per window id in the dense plan's gwg

struct __align__(16) TileSmem {
  int8_t g1[kSlots];
  int8_t g2t[kTile * kG2Stride];
};

// g1 as it is; g2 transposed: g2t[r * kG2Stride + a] = g2[a, r].
__device__ __forceinline__ void stage_tile(TileSmem& s,
                                           const int8_t* __restrict__ g1,
                                           const int8_t* __restrict__ g2) {
  const int4* g1v = reinterpret_cast<const int4*>(g1);
  int4* s1v = reinterpret_cast<int4*>(s.g1);
  for (int i = threadIdx.x; i < kSlots / 16; i += kThreads) {
    s1v[i] = __ldg(g1v + i);
  }
  const int4* g2v = reinterpret_cast<const int4*>(g2);
  for (int i = threadIdx.x; i < kSlots / 16; i += kThreads) {
    const int4 v = __ldg(g2v + i);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
    const int a = i >> 3;          // 8 vectors of 16 bytes a 128-byte row
    const int r0 = (i & 7) << 4;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s.g2t[(r0 + e) * kG2Stride + a] = bytes[e];
    }
  }
}

template <int CAP>
struct Shape {
  static constexpr int kGroup = kTile / CAP;
  static constexpr int kPerThread =
      (kGroup + kRowsPerPass - 1) / kRowsPerPass;
};

// acc[i] += partial[j, l] of one tile, j = jt + kRowsPerPass * i: the
// tile's cap terms are summed first, then added to the window's sum (the
// plain version's order: per-tile partials, then the sum over tiles).
template <int CAP>
__device__ __forceinline__ void accumulate_tile(
    const TileSmem& s, const float* __restrict__ window,
    const int8_t* __restrict__ g3, const float* __restrict__ vals,
    float (&acc)[Shape<CAP>::kPerThread]) {
  constexpr int kGroup = Shape<CAP>::kGroup;
  const int l = threadIdx.x % kTile;
  const int jt = threadIdx.x / kTile;
#pragma unroll
  for (int i = 0; i < Shape<CAP>::kPerThread; ++i) {
    const int j = jt + kRowsPerPass * i;
    if (kGroup % kRowsPerPass != 0 && j >= kGroup) continue;
    float partial = 0.0f;
#pragma unroll 8
    for (int q = 0; q < CAP; ++q) {
      const int r = q * kGroup + j;
      const int slot = r * kTile + l;
      const int a = __ldg(g3 + slot) & (kTile - 1);
      const int b = s.g2t[r * kG2Stride + a] & (kTile - 1);
      const int lane = s.g1[b * kTile + a] & (kTile - 1);
      partial = fmaf(__ldg(window + b * kTile + lane), __ldg(vals + slot),
                     partial);
    }
    acc[i] += partial;
  }
}

template <int CAP>
__device__ __forceinline__ void store_window(
    float* __restrict__ out, int64_t ow,
    const float (&acc)[Shape<CAP>::kPerThread]) {
  constexpr int kGroup = Shape<CAP>::kGroup;
  const int l = threadIdx.x % kTile;
  const int jt = threadIdx.x / kTile;
  float* o = out + ow * (kGroup * kTile);
#pragma unroll
  for (int i = 0; i < Shape<CAP>::kPerThread; ++i) {
    const int j = jt + kRowsPerPass * i;
    if (j < kGroup) o[j * kTile + l] = acc[i];
  }
}

// Where a block of split `sp` stores its window ow: the output itself when
// the walk is not split, else its split's plane of the scratch buffer.
__device__ __forceinline__ float* split_dst(float* out, float* scratch,
                                            int64_t n_windows, int64_t elems) {
  return gridDim.y == 1 ? out : scratch + blockIdx.y * n_windows * elems;
}

// B2: block (ow, sp) walks tiles gw * n_ow_p + ow for its split's share of
// gw = 0..n_gw-1, in order.
template <int CAP>
__global__ void __launch_bounds__(kThreads, 2)
grr_dense_kernel(const float* __restrict__ table_t,
                 const int8_t* __restrict__ g1, const int8_t* __restrict__ g2,
                 const int8_t* __restrict__ g3,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ gwg, float* __restrict__ out,
                 float* __restrict__ scratch, int n_gw, int n_ow_p) {
  __shared__ TileSmem s;
  const int64_t ow = blockIdx.x;
  const int gw_lo = static_cast<int>(
      static_cast<int64_t>(blockIdx.y) * n_gw / gridDim.y);
  const int gw_hi = static_cast<int>(
      static_cast<int64_t>(blockIdx.y + 1) * n_gw / gridDim.y);
  float acc[Shape<CAP>::kPerThread];
#pragma unroll
  for (int i = 0; i < Shape<CAP>::kPerThread; ++i) acc[i] = 0.0f;
  for (int gw = gw_lo; gw < gw_hi; ++gw) {
    const int64_t t = static_cast<int64_t>(gw) * n_ow_p + ow;
    const int64_t base = t * kSlots;
    const int64_t win = __ldg(gwg + t / kDenseB);
    stage_tile(s, g1 + base, g2 + base);
    __syncthreads();
    accumulate_tile<CAP>(s, table_t + win * kSlots, g3 + base, vals + base,
                         acc);
    __syncthreads();
  }
  store_window<CAP>(split_dst(out, scratch, n_ow_p, kSlots / CAP), ow, acc);
}

// First index in the sorted ow_of_st[0, n) whose value is >= key.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a,
                                               int64_t n, int32_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// B3: block (ow, sp) walks its split's share of the run of ow in the
// (ow, gw)-sorted plan.  A window with no supertile is written as 0.
template <int CAP>
__global__ void __launch_bounds__(kThreads, 2)
grr_runs_kernel(const float* __restrict__ table_t,
                const int8_t* __restrict__ g1, const int8_t* __restrict__ g2,
                const int8_t* __restrict__ g3, const float* __restrict__ vals,
                const int32_t* __restrict__ gw_of_st,
                const int32_t* __restrict__ ow_of_st,
                float* __restrict__ out, float* __restrict__ scratch,
                int64_t n_st, int n_ow) {
  __shared__ TileSmem s;
  const int32_t ow = static_cast<int32_t>(blockIdx.x);
  const int64_t first = lower_bound(ow_of_st, n_st, ow);
  const int64_t run = lower_bound(ow_of_st, n_st, ow + 1) - first;
  const int64_t st_lo = first + blockIdx.y * run / gridDim.y;
  const int64_t st_hi = first + (blockIdx.y + 1) * run / gridDim.y;
  float acc[Shape<CAP>::kPerThread];
#pragma unroll
  for (int i = 0; i < Shape<CAP>::kPerThread; ++i) acc[i] = 0.0f;
  for (int64_t st = st_lo; st < st_hi; ++st) {
    const int64_t base = st * kSlots;
    const int64_t win = __ldg(gw_of_st + st);
    stage_tile(s, g1 + base, g2 + base);
    __syncthreads();
    accumulate_tile<CAP>(s, table_t + win * kSlots, g3 + base, vals + base,
                         acc);
    __syncthreads();
  }
  store_window<CAP>(split_dst(out, scratch, n_ow, kSlots / CAP), ow, acc);
}

// out[i] = sum over splits of scratch[sp][i], splits in order.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                  int64_t n, int n_split) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    float sum = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) sum += scratch[sp * n + i];
    out[i] = sum;
  }
}

cudaError_t sum_splits(const float* scratch, float* out, int64_t n,
                       int n_split, cudaStream_t stream) {
  if (n_split == 1) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sum_splits_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096),
                      kThreads, 0, stream>>>(scratch, out, n, n_split);
  return cudaGetLastError();
}

#define GRR_CAPS(F) F(1) F(2) F(4) F(8) F(16) F(32) F(64) F(128)

}  // namespace

// Both launchers run on `stream` (a cudaStream_t passed as void*) and
// return the launch status; they neither synchronise nor allocate.  With
// n_split > 1 each output window's walk over its tiles is cut into n_split
// shares run by separate blocks (so that windows few against the card's
// SMs still fill it); the shares land in `scratch` [n_split, windows,
// 128/cap, 128] and a second kernel sums them, share after share.

extern "C" int grr_contract_dense_launch(
    const float* table_t, const int8_t* g1, const int8_t* g2,
    const int8_t* g3, const float* vals, const int32_t* gwg, float* out,
    float* scratch, int32_t n_gw, int32_t n_ow_p, int32_t cap,
    int32_t n_split, void* stream) {
  if (n_gw <= 0 || n_ow_p <= 0) return static_cast<int>(cudaSuccess);
  if (n_split < 1 || n_split > n_gw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_ow_p, n_split);
  switch (cap) {
#define GRR_DENSE_CASE(C)                                                   \
  case C:                                                                   \
    grr_dense_kernel<C><<<grid, kThreads, 0, s>>>(                          \
        table_t, g1, g2, g3, vals, gwg, out, scratch, n_gw, n_ow_p);        \
    break;
    GRR_CAPS(GRR_DENSE_CASE)
#undef GRR_DENSE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits(
      scratch, out, static_cast<int64_t>(n_ow_p) * (kSlots / cap), n_split,
      s));
}

extern "C" int grr_contract_launch(
    const float* table_t, const int8_t* g1, const int8_t* g2,
    const int8_t* g3, const float* vals, const int32_t* gw_of_st,
    const int32_t* ow_of_st, float* out, float* scratch, int64_t n_st,
    int32_t n_ow, int32_t cap, int32_t n_split, void* stream) {
  if (n_ow <= 0) return static_cast<int>(cudaSuccess);
  if (n_split < 1 || n_split > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_ow, n_split);
  switch (cap) {
#define GRR_RUNS_CASE(C)                                                    \
  case C:                                                                   \
    grr_runs_kernel<C><<<grid, kThreads, 0, s>>>(                           \
        table_t, g1, g2, g3, vals, gw_of_st, ow_of_st, out, scratch, n_st,  \
        n_ow);                                                              \
    break;
    GRR_CAPS(GRR_RUNS_CASE)
#undef GRR_RUNS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits(
      scratch, out, static_cast<int64_t>(n_ow) * (kSlots / cap), n_split, s));
}
