// gather_rowsum: out[i] = sum_k vals[i,k] * table[ids[i,k]]
//
// Replaces photon_ml_tpu/ops/kernels.py::_pallas_gather_rowsum, the
// Pallas kernel for the padded-ELL gather-contract.  On the TPU that
// kernel only ran in interpret mode (Mosaic cannot lower table_ref[ids]);
// Hopper gathers straight from device memory, so here it is the live
// kernel of the serving path's sparse fixed-effect term and of the
// plain-ELL training layout's X.w.
//
// Bound: bytes.  Each row streams k float values and k int32 ids
// (n*k*8 bytes) and writes one float (n*4 bytes); the table is read at
// the distinct ids only.  The arithmetic (2*n*k flops) is far below the
// fp32 rate.  At the serving bucket (64 x 32) launch latency dominates.
//
// What limits it on the H100 (PERF.md, section 6): the streams alone run
// at ~85 % of the HBM rate in this kernel, but a warp's gather of 32
// scattered table entries costs the L1 about one cycle for each distinct
// line it touches, about a gather a cycle an SM, whether it hits or
// misses; at 2^20 x 32 the gathers alone take longer than the streams,
// and the two do not overlap.  Shared memory serves scattered 4-byte
// reads many times faster.  So:
// - The table's head.  On large inputs each block first copies the
//   table's first `head` entries (up to kHeadMax, 224 KB) into its shared
//   memory, and gathers an id below `head` from there, the rest through
//   L1.  (A table split over a 2-block cluster and read through DSMEM was
//   slower than L1; PERF.md.)  Small inputs skip the copy (head = 0): at
//   the serving bucket it costs more than it saves.
// - Bytes in flight.  The streams are read 16 bytes a thread (an int4 of
//   ids, a float4 of vals: 4 consecutive slots of a row) where k % 4 == 0
//   and vals and ids are 16-byte aligned, so TPR = k/4 threads share a
//   row (8 at k = 32: 4 rows a warp; a warp walks a longer row 128 slots
//   at a time).  Blocks are persistent (one an SM), and each thread loads
//   the streams of its next kDepth row groups before it gathers the
//   current ones: kDepth * 32 bytes a thread stay in flight behind the
//   dependent gathers.  The streams are loaded with
//   ld.global.nc.L1::no_allocate, so they pass L1 without evicting the
//   table's tail.
// - A fixed order.  A thread sums its slots in slot order, then a
//   __shfl_xor_sync tree folds the row's TPR threads: no atomics, so two
//   launches agree bit for bit.
// Padding slots (id 0, val 0) are multiplied like any other slot, which
// keeps the JAX semantics exactly (0 * inf = NaN).  Slots past k (a row
// shorter than its threads' reach) are not slots: they add nothing and
// gather nothing.
//
// Where k % 4 != 0 or a stream is not 16-byte aligned, the same kernel
// runs with one slot a thread (VEC = 1): correct, persistent, not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Row groups whose streams a thread has loaded ahead of its gathers.
constexpr int kDepth = 4;
// Table entries a block holds in shared memory at most (224 KB of the
// 227 KB a block may have); ops/kernels.py keeps the same number.
constexpr int kHeadMax = 56 * 1024;

template <int VEC>
struct Chunk {
  float v[VEC];
  int32_t id[VEC];  // -1: not a slot (past k, or a row past n)
};

__device__ __forceinline__ void load_stream(const float* v, const int32_t* id,
                                            Chunk<4>& c) {
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(c.v[0]), "=f"(c.v[1]), "=f"(c.v[2]), "=f"(c.v[3])
      : "l"(v));
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(c.id[0]), "=r"(c.id[1]), "=r"(c.id[2]), "=r"(c.id[3])
      : "l"(id));
}

__device__ __forceinline__ void load_stream(const float* v, const int32_t* id,
                                            Chunk<1>& c) {
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(c.v[0]) : "l"(v));
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(c.id[0]) : "l"(id));
}

// A thread's items, in order: (group, chunk) with the group advancing by
// the grid's warp count after the row's last chunk.  Every lane of a
// warp walks the same items, so a warp takes every branch together.
struct Cursor {
  int64_t group;
  int chunk;
};

template <int VEC, int TPR>
__device__ __forceinline__ void load_item(
    const float* __restrict__ vals, const int32_t* __restrict__ ids,
    int64_t n, int32_t k, int64_t groups, const Cursor& at, int rw, int sub,
    Chunk<VEC>& c) {
  constexpr int RPW = 32 / TPR;
  const int64_t row = at.group * RPW + rw;
  const int j = at.chunk * (VEC * TPR) + sub * VEC;
  if (at.group < groups && row < n && j < k) {
    load_stream(vals + row * k + j, ids + row * k + j, c);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      c.v[e] = 0.0f;
      c.id[e] = -1;
    }
  }
}

__device__ __forceinline__ void advance(Cursor& at, int chunks,
                                        int64_t nwarps) {
  if (++at.chunk == chunks) {
    at.chunk = 0;
    at.group += nwarps;
  }
}

// Copies table[0, head) into shared memory, 16 bytes a load where the
// table is 16-byte aligned.
__device__ __forceinline__ void stage_head(const float* __restrict__ table,
                                           float* head_s, int head) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(table);
    float4* dst = reinterpret_cast<float4*>(head_s);
    for (int i = threadIdx.x; i < head / 4; i += kThreads) dst[i] = __ldg(src + i);
    done = head / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < head; i += kThreads) {
    head_s[i] = __ldg(table + i);
  }
  __syncthreads();
}

template <int VEC, int TPR, bool HEAD>
__global__ void __launch_bounds__(kThreads, 1)
gather_rowsum_kernel(const float* __restrict__ table,
                     const float* __restrict__ vals,
                     const int32_t* __restrict__ ids,
                     float* __restrict__ out, int64_t n, int32_t k,
                     int32_t head) {
  extern __shared__ float4 smem[];
  float* head_s = reinterpret_cast<float*>(smem);
  constexpr int RPW = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;  // the thread's place in its row
  const int rw = lane / TPR;   // its row within the warp's group
  const int64_t groups = (n + RPW - 1) / RPW;
  const int chunks = k > 0 ? (k + VEC * TPR - 1) / (VEC * TPR) : 1;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);

  Cursor load_at{warp, 0};  // the next item whose streams are loaded
  Cursor sum_at{warp, 0};   // the next item whose gathers are summed
  Chunk<VEC> cur[kDepth], nxt[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    load_item<VEC, TPR>(vals, ids, n, k, groups, load_at, rw, sub, cur[d]);
    advance(load_at, chunks, nwarps);
  }
  // The first streams are in flight while the head is copied.
  if (HEAD) stage_head(table, head_s, head);
  float acc = 0.0f;
  while (sum_at.group < groups) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      load_item<VEC, TPR>(vals, ids, n, k, groups, load_at, rw, sub, nxt[d]);
      advance(load_at, chunks, nwarps);
    }
    float g[kDepth][VEC];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int32_t x = cur[d].id[e];
        g[d][e] = x < 0                ? 0.0f
                  : (HEAD && x < head) ? head_s[x]
                                       : __ldg(table + x);
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (sum_at.group < groups) {  // the same for the whole warp
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (cur[d].id[e] >= 0) acc = fmaf(cur[d].v[e], g[d][e], acc);
        }
        if (sum_at.chunk == chunks - 1) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1) {
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          }
          const int64_t row = sum_at.group * RPW + rw;
          if (sub == 0 && row < n) out[row] = acc;
          acc = 0.0f;
        }
        advance(sum_at, chunks, nwarps);
      }
      cur[d] = nxt[d];
    }
  }
}

template <int VEC, bool HEAD>
const void* kernel_of(int tpr) {
  switch (tpr) {
    case 1:
      return reinterpret_cast<const void*>(gather_rowsum_kernel<VEC, 1, HEAD>);
    case 2:
      return reinterpret_cast<const void*>(gather_rowsum_kernel<VEC, 2, HEAD>);
    case 4:
      return reinterpret_cast<const void*>(gather_rowsum_kernel<VEC, 4, HEAD>);
    case 8:
      return reinterpret_cast<const void*>(gather_rowsum_kernel<VEC, 8, HEAD>);
    case 16:
      return reinterpret_cast<const void*>(
          gather_rowsum_kernel<VEC, 16, HEAD>);
    case 32:
      return reinterpret_cast<const void*>(
          gather_rowsum_kernel<VEC, 32, HEAD>);
    default:
      return nullptr;
  }
}

const void* kernel_of(int vec, int tpr, bool head) {
  if (vec == 4) return head ? kernel_of<4, true>(tpr) : kernel_of<4, false>(tpr);
  if (vec == 1) return head ? kernel_of<1, true>(tpr) : kernel_of<1, false>(tpr);
  return nullptr;
}

// ---------------------------------------------------------------------------
// gather_rowsum_lanes: out[i, l] = sum_k vals[i,k] * table[ids[i,k], l]
//
// Replaces photon_ml_tpu/ops/kernels.py::_pallas_gather_rowsum under
// jax.vmap over lambda-lanes: the swept fit of a lambda grid
// (photon_ml_tpu/ops/objective.py sweep_value_and_gradient) contracts one
// shared batch against L coefficient lanes at once, X.W^T over row ELL and
// X^T.R over the transposed ELL.  The table is lane-minor, [T, LANES]: one
// gathered id brings every lane's float in LANES * 4 contiguous bytes (one
// 32-byte sector at 8 lanes), so the ids/vals streams (8 bytes a slot) are
// read once for all lanes instead of once a lane.
//
// Bound: bytes.  n*k*8 bytes of streams, T*LANES*4 of table (each entry
// read once at best) and n*LANES*4 of output; 2*n*k*LANES flops, far below
// the fp32 rate.  On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3,
// PERF.md section 6) it reads 900,000 x 32 slots at 8 lanes in ~0.28 ms,
// 28 % of that bound and 3.5x faster than 8 single-lane launches; its
// time grows with the lanes (the gathered bytes), not with the streams.
//
// Design (simple first): the row layout of gather_rowsum above (TPR
// threads a row, VEC slots a thread, 16-byte stream loads where k % 4 == 0
// and the streams are aligned, the scalar path otherwise); warps walk the
// row groups grid-stride.  A thread keeps LANES accumulators and gathers
// each of its slots' LANES-wide table row with 16-byte loads (8-byte at
// 2 lanes).  A __shfl_xor_sync tree then folds every lane's sum over the
// row's TPR threads, and the row's threads share the 16-byte stores of
// the LANES outputs.  A thread sums its slots in slot order and the tree
// is fixed: no atomics, two launches agree bit for bit.  No shared-memory
// head and no stream prefetch (gather_rowsum's two devices above): a later
// lever.  Padding slots (id 0, val 0) are multiplied like any other slot,
// as in the JAX semantics.
constexpr int kLaneThreads = 256;

template <int LANES>
__device__ __forceinline__ void gather_lane_row(
    const float* __restrict__ table, int32_t x, float (&g)[LANES]) {
  if constexpr (LANES == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(table) + x);
    g[0] = t.x;
    g[1] = t.y;
  } else {
    const float4* p = reinterpret_cast<const float4*>(table) +
                      static_cast<int64_t>(x) * (LANES / 4);
#pragma unroll
    for (int c = 0; c < LANES / 4; ++c) {
      const float4 t = __ldg(p + c);
      g[4 * c] = t.x;
      g[4 * c + 1] = t.y;
      g[4 * c + 2] = t.z;
      g[4 * c + 3] = t.w;
    }
  }
}

template <int VEC, int TPR, int LANES>
__global__ void __launch_bounds__(kLaneThreads)
gather_rowsum_lanes_kernel(const float* __restrict__ table,
                           const float* __restrict__ vals,
                           const int32_t* __restrict__ ids,
                           float* __restrict__ out, int64_t n, int32_t k) {
  constexpr int RPW = 32 / TPR;
  // Output stores: CH chunks of W floats a row (16 bytes, 8 at 2 lanes).
  constexpr int W = LANES == 2 ? 2 : 4;
  constexpr int CH = LANES / W;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const int rw = lane / TPR;
  const int64_t groups = (n + RPW - 1) / RPW;
  const int64_t nwarps =
      static_cast<int64_t>(gridDim.x) * (kLaneThreads / 32);
  for (int64_t group = static_cast<int64_t>(blockIdx.x) *
                           (kLaneThreads / 32) + (threadIdx.x >> 5);
       group < groups; group += nwarps) {
    const int64_t row = group * RPW + rw;
    float acc[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) acc[l] = 0.0f;
    const int32_t end = row < n ? k : 0;
    for (int32_t j = sub * VEC; j < end; j += VEC * TPR) {
      Chunk<VEC> c;
      load_stream(vals + row * k + j, ids + row * k + j, c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float g[LANES];
        gather_lane_row<LANES>(table, c.id[e], g);
#pragma unroll
        for (int l = 0; l < LANES; ++l) acc[l] = fmaf(c.v[e], g[l], acc[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], off);
      }
    }
    if (row < n) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c % TPR == sub) {
          float* dst = out + row * LANES + c * W;
          if constexpr (W == 2) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[2 * c], acc[2 * c + 1]);
          } else {
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
          }
        }
      }
    }
  }
}

template <int VEC, int LANES>
const void* lanes_kernel_of(int tpr) {
  switch (tpr) {
    case 1:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 1, LANES>);
    case 2:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 2, LANES>);
    case 4:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 4, LANES>);
    case 8:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 8, LANES>);
    case 16:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 16, LANES>);
    case 32:
      return reinterpret_cast<const void*>(
          gather_rowsum_lanes_kernel<VEC, 32, LANES>);
    default:
      return nullptr;
  }
}

template <int VEC>
const void* lanes_kernel_of(int lanes, int tpr) {
  switch (lanes) {
    case 2:
      return lanes_kernel_of<VEC, 2>(tpr);
    case 4:
      return lanes_kernel_of<VEC, 4>(tpr);
    case 8:
      return lanes_kernel_of<VEC, 8>(tpr);
    case 16:
      return lanes_kernel_of<VEC, 16>(tpr);
    default:
      return nullptr;
  }
}

const void* lanes_kernel_of(int vec, int lanes, int tpr) {
  if (vec == 4) return lanes_kernel_of<4>(lanes, tpr);
  if (vec == 1) return lanes_kernel_of<1>(lanes, tpr);
  return nullptr;
}

}  // namespace

// On the current device: lets every head variant take kHeadMax floats of
// dynamic shared memory and asks it for the largest shared-memory
// carveout, asks every other variant for the smallest (the largest L1),
// and returns the fewest blocks of any variant that one SM holds at once
// (a negative CUDA status on failure).  The wrapper calls it once a
// device, before the first launch.
extern "C" int gather_rowsum_prepare() {
  int fewest = 1 << 30;
  const int vecs[] = {1, 4};
  for (int vec : vecs) {
    for (int tpr = 1; tpr <= 32; tpr *= 2) {
      for (int head = 0; head < 2; ++head) {
        const void* fn = kernel_of(vec, tpr, head != 0);
        const int smem = head ? kHeadMax * 4 : 0;
        cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess) {
          err = cudaFuncSetAttribute(
              fn, cudaFuncAttributePreferredSharedMemoryCarveout,
              head ? cudaSharedmemCarveoutMaxShared
                   : cudaSharedmemCarveoutMaxL1);
        }
        int blocks = 0;
        if (err == cudaSuccess) {
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                              kThreads, smem);
        }
        if (err != cudaSuccess) return -static_cast<int>(err);
        if (blocks < fewest) fewest = blocks;
      }
    }
  }
  return fewest;
}

// Launches `blocks` persistent blocks of the (vec, tpr) variant on
// `stream` (a cudaStream_t of `device`, passed as void*) and returns the
// launch status; it neither synchronises nor allocates, and leaves the
// calling thread's current device as it found it.  vec = 4 needs k % 4
// == 0 and 16-byte aligned vals and ids; tpr is a power of two up to 32;
// head (0 to kHeadMax, at most the table's length) is the number of the
// table's first entries each block copies into shared memory.
extern "C" int gather_rowsum_launch(const float* table, const float* vals,
                                    const int32_t* ids, float* out,
                                    int64_t n, int32_t k, int32_t vec,
                                    int32_t tpr, int32_t head,
                                    int32_t blocks, int32_t device,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const void* fn = kernel_of(vec, tpr, head > 0);
  if (fn == nullptr || blocks <= 0 || k < 0 || (vec == 4 && k % 4 != 0) ||
      head < 0 || head > kHeadMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&table, &vals, &ids, &out, &n, &k, &head};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned int>(blocks)),
                         dim3(kThreads), args, static_cast<size_t>(head) * 4,
                         static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Launches `blocks` blocks of kLaneThreads threads of the (vec, lanes,
// tpr) variant of gather_rowsum_lanes on `stream` (a cudaStream_t of
// `device`, passed as void*) and returns the launch status; it neither
// synchronises nor allocates, and leaves the calling thread's current
// device as it found it.  table is [T, lanes] and out [n, lanes], both
// contiguous and 16-byte aligned; lanes is 2, 4, 8 or 16; vec = 4 needs
// k % 4 == 0 and 16-byte aligned vals and ids; tpr is a power of two up
// to 32.
extern "C" int gather_rowsum_lanes_launch(const float* table,
                                          const float* vals,
                                          const int32_t* ids, float* out,
                                          int64_t n, int32_t k,
                                          int32_t lanes, int32_t vec,
                                          int32_t tpr, int32_t blocks,
                                          int32_t device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const void* fn = lanes_kernel_of(vec, lanes, tpr);
  if (fn == nullptr || blocks <= 0 || k < 0 || (vec == 4 && k % 4 != 0) ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&table, &vals, &ids, &out, &n, &k};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned int>(blocks)),
                         dim3(kLaneThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
