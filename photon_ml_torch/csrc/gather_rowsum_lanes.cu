// gather_rowsum_lanes: out[i, l] = sum_k vals[i,k] * table[ids[i,k], l]
//
// Replaces photon_ml_tpu/ops/kernels.py::_pallas_gather_rowsum under
// jax.vmap over lambda-lanes: the swept fit of a lambda grid
// (photon_ml_tpu/ops/objective.py sweep_value_and_gradient) contracts one
// shared batch against L coefficient lanes at once, X.W^T over the row ELL
// and X^T.R over the transposed ELL.  The table is lane-minor, [T, LANES]:
// one gathered id brings every lane's float in LANES * 4 contiguous bytes
// (one 32-byte sector at 8 lanes), so the ids/vals streams (8 bytes a
// slot) are read once for all lanes.
//
// Bound: bytes.  n*k*8 bytes of streams, the touched table rows (LANES*4
// bytes each, read once at best) and n*LANES*4 of output; 2*n*k*LANES
// flops, far below the fp32 rate.
//
// What limits it on the H100 (PERF.md, section 6): every gathered slot
// whose row is not in shared memory costs an L1 wavefront and, on a miss,
// a 32-byte L2 sector, on top of the streams' bytes through the same
// L2-to-SM path.  More gathers in flight a thread, or deeper rings, move
// nothing; the share of gathers served from shared memory does.  The
// design:
// - Row tiles staged in shared memory.  A block takes tiles of R rows (R a
//   multiple of 4, so a tile's R*k slots start 16-byte aligned at any k)
//   grid-stride; one producer thread copies each tile's vals span and ids
//   span into a ring of kStages stages with TMA 1D bulk copies
//   (cp.async.bulk, one mbarrier a stage for "full", one for "empty";
//   marked evict-first in L2, so that they do not evict the table), and
//   refills a stage as soon as every consumer warp has released it.  So
//   the next tiles' streams are in flight while the current one gathers,
//   at any k (31 and 264 included): no row needs to start aligned.
// - Few threads a row.  A slot's LANES floats are split over G = LANES/4
//   threads (LANES = 2: one thread, 8 bytes), each gathering 16 bytes, so
//   one warp instruction touches one line a slot and a thread keeps 4
//   accumulators (2 at LANES = 2) whatever LANES is.  P threads split a
//   row's slots into runs of consecutive slots (P the fewest, a power of
//   two, that keep a run at most `run` slots); each sums its run in slot
//   order, 4 gathers in flight, then a fixed __shfl_xor_sync tree folds
//   the P partial sums: no atomics, two launches agree bit for bit.  Runs
//   are read from shared memory 16 bytes at a time where k and the run
//   are multiples of 4 (no bank conflicts at k = 32), else 4 bytes at a
//   time (conflict-free at odd k).
// - The table's head.  Each block may first copy the table's first `head`
//   rows into the shared memory the ring leaves, and gather an id below
//   `head` from there: a scattered shared-memory read of a row costs a
//   fraction of an L1 wavefront and no L2 sector.  One block of 512
//   threads an SM and a ring of 2 stages leave it the most room; deeper
//   rings, two blocks of 256 an SM, more gathers in flight a thread or
//   longer runs were no faster (PERF.md).
// - Output: the row's first P-thread of each lane group writes its 16 (or
//   8) bytes; a row's G stores are contiguous and consecutive rows follow,
//   so a warp's stores coalesce.
// - Persistent grid: the wrapper launches one block an SM, at most one a
//   tile (ops/kernels.py _lane_launch_shape), each walking its tiles.
// Padding slots (id 0, val 0) are multiplied like any other slot, as in
// the JAX semantics (0 * inf = NaN).  Slots past k are not slots.
//
// Streams whose base is not 16-byte aligned (the bulk copy needs it), or
// rows too wide for two stages, take the direct path: the same threads
// and sums, the slots read from device memory 4 bytes at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads that gather and sum a block (one block an SM), and the
// producer warp beside them.
constexpr int kConsumers = 512;
constexpr int kThreads = kConsumers + 32;
// The ring's stages.  Dynamic shared memory: a full and an empty
// barrier a stage, then the head (16-byte rounded), then the ring.
constexpr int kStages = 2;
constexpr int kBarrierBytes = 2 * kStages * 8;
constexpr int kSmemMax = 232448;        // the most a block may ask (227 KB)
constexpr int kUnroll = 4;              // a thread's gathers in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA 1D bulk copy, device memory to shared memory, completing on
// `bar`, with the L2 cache policy `policy` (createpolicy); dst, src and
// bytes are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// An L2 policy that evicts these lines first: the streams are read once,
// and the table's lines should outlive them in L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__host__ __device__ constexpr int64_t round16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// W = 4 floats (16 bytes) or 2 (8 bytes) of a table row, from device
// memory through L1 or from the shared-memory head.
template <int W>
__device__ __forceinline__ void load_global(const float* p, float (&g)[W]) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    g[0] = t.x;
    g[1] = t.y;
    g[2] = t.z;
    g[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    g[0] = t.x;
    g[1] = t.y;
  }
}

template <int W>
__device__ __forceinline__ void load_shared(const float* p, float (&g)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    g[0] = t.x;
    g[1] = t.y;
    g[2] = t.z;
    g[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    g[0] = t.x;
    g[1] = t.y;
  }
}

// The producer: one thread fills the ring with the block's tiles in
// order, a stage's vals span then its ids span, marked evict-first in
// L2.  A tile's span is a multiple of 16 bytes but
// on the last tile of the batch; there the remainder (at most 3 slots) is
// stored by this thread before the arrive.
__device__ void produce(const float* __restrict__ vals,
                        const int32_t* __restrict__ ids, int64_t n,
                        int32_t k, int32_t tile_rows, unsigned char* ring,
                        uint64_t* full, uint64_t* empty) {
  const uint64_t policy = evict_first_policy();
  const int64_t tile_slots = static_cast<int64_t>(tile_rows) * k;
  const int64_t stage_bytes = tile_slots * 8;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  int32_t i = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(empty + s, ((i / kStages) - 1) & 1);
    const int64_t row0 = tile * tile_rows;
    const int64_t rows = n - row0 < tile_rows ? n - row0 : tile_rows;
    const int64_t slots = rows * k;
    const uint32_t bulk = static_cast<uint32_t>(slots * 4) & ~15u;
    float* sv = reinterpret_cast<float*>(ring + s * stage_bytes);
    int32_t* si = reinterpret_cast<int32_t*>(ring + s * stage_bytes +
                                             tile_slots * 4);
    const float* gv = vals + row0 * k;
    const int32_t* gi = ids + row0 * k;
    for (int64_t e = bulk / 4; e < slots; ++e) {
      sv[e] = gv[e];
      si[e] = gi[e];
    }
    mbar_arrive_expect_tx(full + s, 2 * bulk);
    if (bulk > 0) {
      bulk_copy(sv, gv, bulk, full + s, policy);
      bulk_copy(si, gi, bulk, full + s, policy);
    }
  }
}

// One thread's run of `len` slots starting at slot `off` of its tile
// (tv/ti: the tile's vals and ids, in shared memory when STAGED, else in
// device memory), summed in slot order into acc: W lanes (the thread's
// lane group g) of each slot's table row.
template <int LANES, bool STAGED, bool HEAD, int VEC>
__device__ __forceinline__ void sum_run(
    const float* __restrict__ table, const float* head_s, int32_t head,
    const float* tv, const int32_t* ti, int64_t off, int32_t len, int g,
    float (&acc)[LANES == 2 ? 2 : 4]) {
  constexpr int W = LANES == 2 ? 2 : 4;
  for (int32_t j = 0; j < len; j += kUnroll) {
    float v[kUnroll];
    int32_t x[kUnroll];
    if constexpr (VEC == 4) {
      // len is a multiple of 4 and off of 4: 16-byte reads of each.
#pragma unroll
      for (int q = 0; q < kUnroll / 4; ++q) {
        float4 vv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int4 xx = make_int4(0, 0, 0, 0);
        if (j + 4 * q < len) {
          vv = *reinterpret_cast<const float4*>(tv + off + j + 4 * q);
          xx = *reinterpret_cast<const int4*>(ti + off + j + 4 * q);
        }
        v[4 * q] = vv.x;
        v[4 * q + 1] = vv.y;
        v[4 * q + 2] = vv.z;
        v[4 * q + 3] = vv.w;
        x[4 * q] = xx.x;
        x[4 * q + 1] = xx.y;
        x[4 * q + 2] = xx.z;
        x[4 * q + 3] = xx.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) {
        const bool in = j + e < len;
        if constexpr (STAGED) {
          v[e] = in ? tv[off + j + e] : 0.0f;
          x[e] = in ? ti[off + j + e] : 0;
        } else {
          v[e] = in ? __ldg(tv + off + j + e) : 0.0f;
          x[e] = in ? __ldg(ti + off + j + e) : 0;
        }
      }
    }
    float gv[kUnroll][W];
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      if (j + e < len) {
        const int64_t at = static_cast<int64_t>(x[e]) * LANES + g * W;
        if (HEAD && x[e] < head) {
          load_shared<W>(head_s + at, gv[e]);
        } else {
          load_global<W>(table + at, gv[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      if (j + e < len) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(v[e], gv[e][w], acc[w]);
      }
    }
  }
}

template <int LANES, bool STAGED, bool HEAD, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gather_rowsum_lanes_kernel(const float* __restrict__ table,
                           const float* __restrict__ vals,
                           const int32_t* __restrict__ ids,
                           float* __restrict__ out, int64_t n, int32_t k,
                           int32_t slot_threads, int32_t run,
                           int32_t tile_rows, int32_t head) {
  constexpr int W = LANES == 2 ? 2 : 4;
  constexpr int G = LANES / W;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* head_s = reinterpret_cast<float*>(smem + kBarrierBytes);
  unsigned char* ring =
      smem + kBarrierBytes + (HEAD ? round16(int64_t{head} * LANES * 4) : 0);
  const int64_t tile_slots = static_cast<int64_t>(tile_rows) * k;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;

  if constexpr (STAGED) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  if (threadIdx.x >= kConsumers) {
    if (STAGED && threadIdx.x == kConsumers) {
      produce(vals, ids, n, k, tile_rows, ring, full, empty);
    }
    return;
  }
  const int t = threadIdx.x;
  if constexpr (HEAD) {
    // The first streams are in flight while the head is copied.
    const int64_t floats = int64_t{head} * LANES;
    const float4* src = reinterpret_cast<const float4*>(table);
    float4* dst = reinterpret_cast<float4*>(head_s);
    for (int64_t q = t; q < floats / 4; q += kConsumers) {
      dst[q] = __ldg(src + q);
    }
    for (int64_t q = floats / 4 * 4 + t; q < floats; q += kConsumers) {
      head_s[q] = __ldg(table + q);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }

  const int g = t % G;                    // the thread's lane group
  const int p = (t / G) % slot_threads;   // its run within the row
  const int tpr = G * slot_threads;       // threads a row
  const int rw = t / tpr;                 // its row within a pass
  const int rows_a_pass = kConsumers / tpr;
  const int32_t j0 = p * run < k ? p * run : k;
  const int32_t j1 = j0 + run < k ? j0 + run : k;
  int32_t i = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int64_t row0 = tile * tile_rows;
    const int rows = static_cast<int>(n - row0 < tile_rows ? n - row0
                                                           : tile_rows);
    const float* tv;
    const int32_t* ti;
    int s = 0;
    if constexpr (STAGED) {
      s = i % kStages;
      mbar_wait(full + s, (i / kStages) & 1);
      tv = reinterpret_cast<const float*>(ring + s * tile_slots * 8);
      ti = reinterpret_cast<const int32_t*>(ring + s * tile_slots * 8 +
                                            tile_slots * 4);
    } else {
      tv = vals + row0 * k;
      ti = ids + row0 * k;
    }
    // Every thread of a warp takes every pass, so the folds see whole
    // warps; a row past the tile sums nothing.
    for (int base = 0; base < rows; base += rows_a_pass) {
      const int r = base + rw;
      float acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0.0f;
      sum_run<LANES, STAGED, HEAD, VEC>(
          table, head_s, head, tv, ti, static_cast<int64_t>(r) * k + j0,
          r < rows ? j1 - j0 : 0, g, acc);
      for (int o = G; o < tpr; o <<= 1) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], o);
        }
      }
      if (p == 0 && r < rows) {
        float* dst = out + (row0 + r) * LANES + g * W;
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
        }
      }
    }
    if constexpr (STAGED) {
      // The warp is done with the stage: one arrival a warp.
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(empty + s);
    }
  }
}

// Variants: LANES x {direct, staged, staged with a head} x VEC (4 on the
// staged paths only).
template <int LANES>
const void* lanes_kernel_of(int staged, int head, int vec) {
  if (!staged) {
    return vec == 1 ? reinterpret_cast<const void*>(
                          gather_rowsum_lanes_kernel<LANES, false, false, 1>)
                    : nullptr;
  }
  if (vec == 4) {
    return head ? reinterpret_cast<const void*>(
                      gather_rowsum_lanes_kernel<LANES, true, true, 4>)
                : reinterpret_cast<const void*>(
                      gather_rowsum_lanes_kernel<LANES, true, false, 4>);
  }
  if (vec == 1) {
    return head ? reinterpret_cast<const void*>(
                      gather_rowsum_lanes_kernel<LANES, true, true, 1>)
                : reinterpret_cast<const void*>(
                      gather_rowsum_lanes_kernel<LANES, true, false, 1>);
  }
  return nullptr;
}

const void* lanes_kernel_of(int lanes, int staged, int head, int vec) {
  switch (lanes) {
    case 2:
      return lanes_kernel_of<2>(staged, head, vec);
    case 4:
      return lanes_kernel_of<4>(staged, head, vec);
    case 8:
      return lanes_kernel_of<8>(staged, head, vec);
    case 16:
      return lanes_kernel_of<16>(staged, head, vec);
    default:
      return nullptr;
  }
}

// The dynamic shared memory a staged launch takes: the barriers, the
// first `head` table rows and the ring.
int64_t smem_bytes(int32_t lanes, int32_t k, int32_t tile_rows,
                   int32_t head) {
  return kBarrierBytes + round16(int64_t{head} * lanes * 4) +
         int64_t{kStages} * tile_rows * k * 8;
}

bool power_of_two(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// On the current device: lets every variant take up to 227 KB of dynamic
// shared memory, and returns the blocks of kThreads threads an SM holds
// at once of the variant that holds fewest (each at the most shared
// memory it may take), or a negative CUDA status.  The wrapper calls it
// once a device, before the first launch, and launches one block an SM.
extern "C" int gather_rowsum_lanes_prepare() {
  const int widths[] = {2, 4, 8, 16};
  int fewest = 1 << 30;
  for (int lanes : widths) {
    for (int staged = 0; staged < 2; ++staged) {
      for (int head = 0; head < 2; ++head) {
        for (int vec = 1; vec <= 4; vec += 3) {
          const void* fn = lanes_kernel_of(lanes, staged, head, vec);
          if (fn == nullptr) continue;
          const int smem = staged ? kSmemMax : 0;
          cudaError_t err = cudaFuncSetAttribute(
              fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
          int blocks = 0;
          if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, fn, kThreads, smem);
          }
          if (err != cudaSuccess) return -static_cast<int>(err);
          if (blocks < fewest) fewest = blocks;
        }
      }
    }
  }
  return fewest;
}

// Launches `blocks` persistent blocks of kThreads threads of the (lanes,
// staged, head > 0, vec) variant on `stream` (a cudaStream_t of `device`,
// passed as void*), and returns the launch status; it neither
// synchronises nor allocates, and leaves the calling thread's current
// device as it found it.  table is [T, lanes] and out [n, lanes], both
// contiguous and 16-byte aligned; lanes is 2, 4, 8 or 16.  slot_threads
// (P, a power of two) times lanes/4 (1 at 2 lanes) threads share a row,
// each summing a run of at most `run` slots (P * run >= k).  The staged
// path needs 16-byte aligned vals and ids, tile_rows a multiple of 4, and
// its barriers, the first `head` table rows (at most the table's) and two
// stages of tile_rows * k slots within 227 KB of shared memory; vec = 4
// needs k and run multiples of 4.
extern "C" int gather_rowsum_lanes_launch(
    const float* table, const float* vals, const int32_t* ids, float* out,
    int64_t n, int32_t k, int32_t lanes, int32_t staged, int32_t vec,
    int32_t slot_threads, int32_t run, int32_t tile_rows, int32_t head,
    int32_t blocks, int32_t device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const void* fn = lanes_kernel_of(lanes, staged, head > 0, vec);
  const int g = lanes == 2 ? 1 : lanes / 4;
  const int64_t smem = staged ? smem_bytes(lanes, k, tile_rows, head) : 0;
  const bool bad =
      fn == nullptr || blocks <= 0 || k < 0 || tile_rows <= 0 ||
      !power_of_two(slot_threads) || g * slot_threads > 32 || run < 0 ||
      int64_t{slot_threads} * run < k || head < 0 || (!staged && head) ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (vec == 4 && (k % 4 != 0 || run % 4 != 0)) ||
      (staged && (tile_rows % 4 != 0 ||
                  ((reinterpret_cast<uintptr_t>(vals) |
                    reinterpret_cast<uintptr_t>(ids)) & 15) != 0)) ||
      smem > kSmemMax;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&table, &vals, &ids, &out, &n, &k,
                  &slot_threads, &run, &tile_rows, &head};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned int>(blocks)),
                         dim3(kThreads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
