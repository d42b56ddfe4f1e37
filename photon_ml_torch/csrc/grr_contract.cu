// GRR contraction: execute a compiled gather-route-reduce plan.
//
// Replaces the two Pallas kernels of photon_ml_tpu/ops/grr_kernel.py:
//   grr_contract_kernel_dense (B2)  -> grr_contract_dense_launch
//   grr_contract_kernel       (B3)  -> grr_contract_launch
// Both run the plan that photon_ml_torch/data/grr.py builds (the same plan
// the JAX package builds): per supertile ("tile") of 128 x 128 slots, int8
// planes g1, g2, g3 and float values vals; the table as windows of
// 128 x 128.
//
// What one output slot computes (the three lane gathers of the TPU kernel,
// composed into one chain of indexed reads):
//   a = g3[r,l];  b = g2[a,r];  x3 = window[b, g1[b,a]];  c = x3 * vals[r,l]
//   partial[j,l] = sum_{q < cap} c[q * (128 / cap) + j, l]
// B2 (dense grid): tile t = gw * n_ow_p + ow; out[ow] = sum over gw.
// B3: tiles sorted by (ow, gw); out[ow] = sum of its run's partials.
//
// Bound: bytes.  Every slot streams 7 bytes from HBM (vals f32 + g1/g2/g3
// i8) once; the table windows (<= a few MB, L2-resident) and the output are
// small beside that; one fma a slot.  Three things kept this kernel's first
// version at 14-37 % of that bound: each slot's window read was a scattered
// 4-byte L2 access (a 32-byte sector for 7 streamed bytes); a block had one
// tile in flight, with its loads, the g2 transpose and the compute in
// series; and small levels filled less than one wave of the card.
//
// Design:
// 1. Gathers from shared memory.  A tile's 64 KB table window is staged
//    into shared memory with g1 and g2, so all three lookups of a slot's
//    chain read shared memory (~3-4 wavefronts a warp for random banks)
//    instead of 32 L2 sectors.  The window is staged for each tile (64 KB of
//    coalesced L2 -> shared a tile; the table stays in L2).
// 2. Pipelined plane loads.  A ring of two stages (window + g1 + g2, 96 KB
//    each) is filled by TMA 1-D bulk copies (cp.async.bulk completing on an
//    mbarrier), issued by one thread two tiles ahead.  g3 and vals are read
//    once, so they stream straight from global memory into registers with
//    16-byte loads: as a thread consumes a row of this tile it loads the
//    same row of its next tile, so a whole tile's compute hides their
//    latency.  One 512-thread block an SM (221 KB of shared memory).
// 3. g2 without the byte transpose in the load loop.  g2 arrives by bulk
//    copy as it is and is transposed in shared memory (4 x 4 byte blocks,
//    __byte_perm, a diagonal order that keeps the reads and the writes free
//    of bank conflicts) into g2t[r][a]: the lookup g2[a, r] at a fixed row r
//    reads one 128-byte row, conflict-free without padding.
// 4. Wider per-thread work.  A thread takes 4 adjacent lanes (a char4 of g3,
//    a float4 of vals); a warp covers one 128-lane row; warp w takes rows
//    w + 16 i.  Each thread keeps its rows' partials in registers.
// 5. Tile-level scheduling.  The tiles, in (ow, gw) order (B2's dense grid
//    read in that order, B3's plan as sorted), are cut into one contiguous
//    range per block, min(tiles, SMs) blocks: every level fills the card in
//    one wave and no block waits on a long window.  A window whose run lies
//    inside one range is written directly; a run cut by a range boundary
//    leaves its pieces in scratch [blocks, 2, 128/cap, 128], and after a
//    grid-wide barrier one block adds them, block after block, in the same
//    launch (cooperative, so that all blocks are resident: at most one an
//    SM).  The barrier and that pass run only where a boundary can cut a
//    run (B2: decided on the host from the grid; B3: any launch of more
//    than one block).  B3's empty windows are written as 0.
// 6. The same summation order, deterministic: each tile's cap terms first
//    (for caps > 8 several warps hold a tile's terms of one output row; they
//    are combined in shared memory in warp order), then tile after tile in
//    gw order, then the cut pieces block after block.  No atomics.
// 7. One launch per plan level.
// Lane indices are 0..127 by construction; they are masked to 7 bits so
// that a corrupt plan cannot read outside its tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kSlots = kTile * kTile;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kStages = 2;
constexpr int kDenseB = 4;  // tiles per window id in the dense plan's gwg

struct Stage {
  float window[kSlots];
  int8_t g1[kSlots];
  int8_t g2[kSlots];
};
constexpr uint32_t kStageBytes = sizeof(Stage);

struct Smem {
  Stage stage[kStages];
  uint8_t g2t[kSlots];
  float4 red[kWarps][32];  // per-warp tile partials, for caps > 8
  uint64_t full[kStages];  // one mbarrier a stage
};

template <int CAP>
struct Shape {
  static constexpr int kGroup = kTile / CAP;
  // Output rows a thread owns (one float4 each), and warps sharing a row.
  static constexpr int kOwned = kGroup >= kWarps ? kGroup / kWarps : 1;
  static constexpr int kSharers = kGroup >= kWarps ? 1 : kWarps / kGroup;
};

// B2: tile k of the (ow, gw) order is plane gw * n_ow_p + ow.
struct DenseMap {
  const int32_t* gwg;
  int n_gw;
  int n_ow_p;
  __device__ int64_t plane(int64_t k) const {
    return (k % n_gw) * n_ow_p + k / n_gw;
  }
  __device__ int ow(int64_t k) const { return static_cast<int>(k / n_gw); }
  __device__ int64_t window(int64_t k) const {
    return __ldg(gwg + plane(k) / kDenseB);
  }
};

// B3: the plan is already in (ow, gw) order.
struct RunsMap {
  const int32_t* gw_of_st;
  const int32_t* ow_of_st;
  __device__ int64_t plane(int64_t k) const { return k; }
  __device__ int ow(int64_t k) const { return __ldg(ow_of_st + k); }
  __device__ int64_t window(int64_t k) const { return __ldg(gw_of_st + k); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: stage tile k's window, g1 and g2 into `st`.
template <class Map>
__device__ __forceinline__ void issue_tile(Stage& st, uint64_t* bar,
                                           const Map& map, int64_t k,
                                           const float* table_t,
                                           const int8_t* g1,
                                           const int8_t* g2) {
  const uint32_t b = smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(kStageBytes)
      : "memory");
  const int64_t p = map.plane(k) * kSlots;
  bulk_load(st.window, table_t + map.window(k) * kSlots, kSlots * 4, b);
  bulk_load(st.g1, g1 + p, kSlots, b);
  bulk_load(st.g2, g2 + p, kSlots, b);
}

// g2t[r * 128 + a] = g2[a * 128 + r], in 4 x 4 byte blocks (A, R) = (a/4,
// r/4).  A warp takes A = lane, R = (A + diagonal) % 32: the reads (bank R)
// and the writes (bank A) each touch 32 banks.
__device__ __forceinline__ void transpose_g2(const int8_t* raw,
                                             uint8_t* g2t) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(raw);
  uint32_t* o = reinterpret_cast<uint32_t*>(g2t);
#pragma unroll
  for (int e = 0; e < kSlots / 16 / kThreads; ++e) {
    const int p = threadIdx.x + e * kThreads;
    const int A = p & 31;
    const int R = (A + (p >> 5)) & 31;
    const uint32_t w0 = in[(4 * A + 0) * 32 + R];
    const uint32_t w1 = in[(4 * A + 1) * 32 + R];
    const uint32_t w2 = in[(4 * A + 2) * 32 + R];
    const uint32_t w3 = in[(4 * A + 3) * 32 + R];
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
    const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    o[(4 * R + 0) * 32 + A] = __byte_perm(t0, t2, 0x5410);
    o[(4 * R + 1) * 32 + A] = __byte_perm(t0, t2, 0x7632);
    o[(4 * R + 2) * 32 + A] = __byte_perm(t1, t3, 0x5410);
    o[(4 * R + 3) * 32 + A] = __byte_perm(t1, t3, 0x7632);
  }
}

// This thread's g3 word and vals float4 of row w + 16 i of a tile.
__device__ __forceinline__ void load_rows(const int8_t* g3, const float* vals,
                                          uint32_t (&g3r)[kRowsPerWarp],
                                          float4 (&vr)[kRowsPerWarp], int w,
                                          int t, int i) {
  const int r = w + kWarps * i;
  g3r[i] = static_cast<uint32_t>(
      __ldcs(reinterpret_cast<const int*>(g3 + r * kTile) + t));
  vr[i] = __ldcs(reinterpret_cast<const float4*>(vals + r * kTile) + t);
}

__device__ __forceinline__ float slot_term(const Stage& st,
                                           const uint8_t* g2row, uint32_t a,
                                           float v, float acc) {
  a &= kTile - 1;
  const int b = g2row[a] & (kTile - 1);
  const int lane = st.g1[b * kTile + a] & (kTile - 1);
  return fmaf(st.window[b * kTile + lane], v, acc);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One tile.  Owned slot s of this thread is output row j = w + 16 s; it
// sums the tile's cap terms of that row (rows j + group q) and adds them to
// acc[s].  For caps > 8 (kSharers > 1) the warp holds a share of the cap
// terms of row w % group, returned in `share` for the cross-warp sum.  As
// each row is consumed the same row of the next tile (at g3n/valsn, or
// none) is loaded in its place.
template <int CAP>
__device__ __forceinline__ void tile_rows(
    const Stage& st, const uint8_t* g2t, uint32_t (&g3r)[kRowsPerWarp],
    float4 (&vr)[kRowsPerWarp], const int8_t* g3n, const float* valsn, int w,
    int t, float4 (&acc)[Shape<CAP>::kOwned], float4& share) {
  constexpr int kOwned = Shape<CAP>::kOwned;
#pragma unroll
  for (int s = 0; s < kOwned; ++s) {
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kRowsPerWarp / kOwned; ++m) {
      const int i = s + kOwned * m;
      const uint8_t* g2row = g2t + (w + kWarps * i) * kTile;
      const uint32_t a = g3r[i];
      const float4 v = vr[i];
      p.x = slot_term(st, g2row, a, v.x, p.x);
      p.y = slot_term(st, g2row, a >> 8, v.y, p.y);
      p.z = slot_term(st, g2row, a >> 16, v.z, p.z);
      p.w = slot_term(st, g2row, a >> 24, v.w, p.w);
      if (g3n != nullptr) load_rows(g3n, valsn, g3r, vr, w, t, i);
    }
    if (Shape<CAP>::kSharers == 1) {
      add4(acc[s], p);
    } else {
      share = p;
    }
  }
}

// out[from..to) = 0, windows of `elems` floats; the whole block.
__device__ __forceinline__ void zero_windows(float* out, int64_t from,
                                             int64_t to, int64_t elems) {
  if (to <= from) return;
  float4* o = reinterpret_cast<float4*>(out + from * elems);
  const int64_t n = (to - from) * elems / 4;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Block b runs tiles [b * n / B, (b + 1) * n / B) of the (ow, gw) order.
__device__ __forceinline__ int64_t range_lo(int64_t b, int64_t n,
                                            int64_t blocks) {
  return b * n / blocks;
}

// out[X] for each window X whose run the tile ranges cut: block b adds the
// pieces of the run that ends its range and starts in it, block after block.
template <int CAP, class Map>
__device__ __forceinline__ void sum_pieces(const Map& map, int64_t n_tiles,
                                           int n_ow, const float* scratch,
                                           float* out) {
  constexpr int64_t kElems = static_cast<int64_t>(kTile / CAP) * kTile;
  const int64_t blocks = gridDim.x;
  const int64_t b = blockIdx.x;
  const int64_t lo = range_lo(b, n_tiles, blocks);
  const int64_t hi = range_lo(b + 1, n_tiles, blocks);
  const int x = map.ow(hi - 1);
  if (hi >= n_tiles || map.ow(hi) != x) return;  // not cut here
  if (lo > 0 && map.ow(lo - 1) == x) return;     // an earlier block starts it
  if (x < 0 || x >= n_ow) return;
  int64_t last = b + 1;
  while (range_lo(last + 1, n_tiles, blocks) < n_tiles &&
         map.ow(range_lo(last + 1, n_tiles, blocks)) == x) {
    ++last;
  }
  const float4* first = reinterpret_cast<const float4*>(
      scratch + (b * 2 + (map.ow(lo) == x ? 0 : 1)) * kElems);
  float4* o = reinterpret_cast<float4*>(out + x * kElems);
  for (int64_t i = threadIdx.x; i < kElems / 4; i += kThreads) {
    float4 sum = first[i];
    for (int64_t bb = b + 1; bb <= last; ++bb) {
      add4(sum, reinterpret_cast<const float4*>(scratch + bb * 2 * kElems)[i]);
    }
    o[i] = sum;
  }
}

template <int CAP, class Map>
__global__ void __launch_bounds__(kThreads, 1)
grr_tiles_kernel(const float* __restrict__ table_t,
                 const int8_t* __restrict__ g1, const int8_t* __restrict__ g2,
                 const int8_t* __restrict__ g3,
                 const float* __restrict__ vals, Map map, int64_t n_tiles,
                 int n_ow, float* __restrict__ out,
                 float* __restrict__ scratch, int pieces) {
  constexpr int kGroup = Shape<CAP>::kGroup;
  constexpr int kOwned = Shape<CAP>::kOwned;
  constexpr int kSharers = Shape<CAP>::kSharers;
  constexpr int64_t kElems = static_cast<int64_t>(kGroup) * kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int w = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int64_t blk = blockIdx.x;
  if (n_tiles == 0) {
    if (blk == 0) zero_windows(out, 0, n_ow, kElems);
    return;
  }
  const int64_t lo = range_lo(blk, n_tiles, gridDim.x);
  const int64_t hi = range_lo(blk + 1, n_tiles, gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&sm.full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages && lo + s < hi; ++s) {
      issue_tile(sm.stage[s], &sm.full[s], map, lo + s, table_t, g1, g2);
    }
  }
  uint32_t g3r[kRowsPerWarp];
  float4 vr[kRowsPerWarp];
  {
    const int64_t p = map.plane(lo) * kSlots;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      load_rows(g3 + p, vals + p, g3r, vr, w, t, i);
    }
  }
  float4 acc[kOwned];
#pragma unroll
  for (int s = 0; s < kOwned; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int first_ow = map.ow(lo);
  int cur = first_ow;
  bool started_here = lo == 0 || map.ow(lo - 1) != cur;
  if (started_here) zero_windows(out, lo == 0 ? 0 : map.ow(lo - 1) + 1, cur,
                                 kElems);
  for (int64_t k = lo; k < hi; ++k) {
    const int s = static_cast<int>((k - lo) % kStages);
    mbar_wait(&sm.full[s], static_cast<uint32_t>((k - lo) / kStages) & 1);
    transpose_g2(sm.stage[s].g2, sm.g2t);
    __syncthreads();
    const bool more = k + 1 < hi;
    const int64_t pn = more ? map.plane(k + 1) * kSlots : 0;
    float4 share;
    tile_rows<CAP>(sm.stage[s], sm.g2t, g3r, vr, more ? g3 + pn : nullptr,
                   vals + pn, w, t, acc, share);
    if (kSharers > 1) sm.red[w][t] = share;
    __syncthreads();  // stage s, g2t and red are read
    if (threadIdx.x == 0 && k + kStages < hi) {
      issue_tile(sm.stage[s], &sm.full[s], map, k + kStages, table_t, g1, g2);
    }
    if (kSharers > 1 && w < kGroup) {
      float4 sum = sm.red[w][t];
#pragma unroll
      for (int m = 1; m < kSharers; ++m) add4(sum, sm.red[w + kGroup * m][t]);
      add4(acc[0], sum);
    }
    const int nxt = more ? map.ow(k + 1) : -1;
    if (nxt == cur) continue;
    // Window `cur` ends here: its run was cut by a range boundary unless it
    // started and ends inside this range.
    const bool ends_here = more || hi == n_tiles || map.ow(hi) != cur;
    if (cur >= 0 && cur < n_ow && (kSharers == 1 || w < kGroup)) {
      const bool direct = started_here && ends_here;
      const int64_t piece = blk * 2 + (cur == first_ow ? 0 : 1);
      float* dst = direct ? out + cur * kElems : scratch + piece * kElems;
#pragma unroll
      for (int o = 0; o < kOwned; ++o) {
        const int j = kSharers == 1 ? w + kWarps * o : w;
        reinterpret_cast<float4*>(dst + j * kTile)[t] = acc[o];
      }
    }
#pragma unroll
    for (int o = 0; o < kOwned; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (more) {
      zero_windows(out, cur + 1, nxt, kElems);
      cur = nxt;
      started_here = true;
    }
  }
  if (hi == n_tiles) zero_windows(out, cur + 1, n_ow, kElems);
  if (pieces) {
    cooperative_groups::this_grid().sync();
    sum_pieces<CAP>(map, n_tiles, n_ow, scratch, out);
  }
}

template <int CAP, class Map>
cudaError_t launch_cap(const float* table_t, const int8_t* g1,
                       const int8_t* g2, const int8_t* g3, const float* vals,
                       Map map, int64_t n_tiles, int n_ow, float* out,
                       float* scratch, int n_blocks, int pieces,
                       cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      grr_tiles_kernel<CAP, Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  if (!pieces) {
    grr_tiles_kernel<CAP, Map><<<n_blocks, kThreads, smem, stream>>>(
        table_t, g1, g2, g3, vals, map, n_tiles, n_ow, out, scratch, pieces);
    return cudaGetLastError();
  }
  // The pieces pass waits on a grid-wide barrier: a cooperative launch
  // guarantees that all n_blocks (<= one an SM) blocks are resident.
  void* args[] = {&table_t, &g1, &g2, &g3, &vals, &map,
                  &n_tiles, &n_ow, &out, &scratch, &pieces};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grr_tiles_kernel<CAP, Map>),
      dim3(n_blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class Map>
cudaError_t launch(int cap, const float* table_t, const int8_t* g1,
                   const int8_t* g2, const int8_t* g3, const float* vals,
                   const Map& map, int64_t n_tiles, int n_ow, float* out,
                   float* scratch, int n_blocks, int pieces,
                   cudaStream_t stream) {
  switch (cap) {
#define GRR_CASE(C)                                                        \
  case C:                                                                  \
    return launch_cap<C>(table_t, g1, g2, g3, vals, map, n_tiles, n_ow,    \
                         out, scratch, n_blocks, pieces, stream);
    GRR_CASE(1) GRR_CASE(2) GRR_CASE(4) GRR_CASE(8) GRR_CASE(16)
    GRR_CASE(32) GRR_CASE(64) GRR_CASE(128)
#undef GRR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both launchers run on `stream` (a cudaStream_t passed as void*) and
// return the launch status; they neither synchronise nor allocate.
// `n_blocks` (1 ..= the tile count; 1 for an empty plan) is the number of
// tile ranges; `scratch` holds [n_blocks, 2, 128/cap, 128] floats when
// n_blocks > 1.  Every pointer is 16-byte aligned (the bulk copies and the
// vector loads need it).

extern "C" int grr_contract_dense_launch(
    const float* table_t, const int8_t* g1, const int8_t* g2,
    const int8_t* g3, const float* vals, const int32_t* gwg, float* out,
    float* scratch, int32_t n_gw, int32_t n_ow_p, int32_t cap,
    int32_t n_blocks, void* stream) {
  if (n_gw <= 0 || n_ow_p <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = static_cast<int64_t>(n_gw) * n_ow_p;
  if (n_blocks < 1 || n_blocks > n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A second pass only if some range boundary falls inside a window's gw
  // walk.
  int pieces = 0;
  for (int64_t b = 1; b < n_blocks && !pieces; ++b) {
    pieces = (b * n_tiles / n_blocks) % n_gw != 0;
  }
  const DenseMap map{gwg, n_gw, n_ow_p};
  return static_cast<int>(launch(cap, table_t, g1, g2, g3, vals, map,
                                 n_tiles, n_ow_p, out, scratch, n_blocks,
                                 pieces, static_cast<cudaStream_t>(stream)));
}

extern "C" int grr_contract_launch(
    const float* table_t, const int8_t* g1, const int8_t* g2,
    const int8_t* g3, const float* vals, const int32_t* gw_of_st,
    const int32_t* ow_of_st, float* out, float* scratch, int64_t n_st,
    int32_t n_ow, int32_t cap, int32_t n_blocks, void* stream) {
  if (n_ow <= 0) return static_cast<int>(cudaSuccess);
  if (n_blocks < 1 || n_blocks > (n_st > 0 ? n_st : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RunsMap map{gw_of_st, ow_of_st};
  return static_cast<int>(launch(cap, table_t, g1, g2, g3, vals, map, n_st,
                                 n_ow, out, scratch, n_blocks, n_blocks > 1,
                                 static_cast<cudaStream_t>(stream)));
}
