// sorted_colsum: out[j] = sum over s in [col_ptr[j], col_ptr[j+1]) of
//                          vals[s] * r[rows[s]]
//
// Xt.r over a column-sorted copy of a plain-ELL batch's slots
// (data/colsorted.py): each slot's row and value, sorted by column, rows
// ascending within a column, zero-valued slots dropped.  It replaces no
// TPU kernel: the JAX package's plain-ELL Xt.r is XLA's
// jax.ops.segment_sum (photon_ml_tpu/data/batch.py:127-132), which the
// port first wrote as a float64 index_add_ scatter with atomics.  Each
// product is rounded to float32, as the scatter's was; the sum is taken
// in float64 and rounded once to float32.  No atomics: two launches
// agree bit for bit.
//
// Bound: bytes.  rows and vals are read once (8 bytes a slot), col_ptr
// once (8 bytes a column), out written once (4 bytes a column); r (4
// bytes a row) is gathered.  At the benchmark's glm-fit shape (1.2e8
// slots over 54,686,453 columns, r over 1e7 rows) that is ~1.62 GB,
// 0.48 ms at 3.35 TB/s.  The arithmetic (a float32 product and a float64
// add a slot) is far below the card's rates.
//
// What the design does about it:
// - Merge-path partition (Merrill and Garland, "Merge-based parallel
//   sparse matrix-vector multiplication", SC'16).  The column ends and
//   the slots form one merged list of dim + nnz items; every block takes
//   kTile consecutive items, so a column of 1e7 slots (the intercept) and
//   millions of empty columns load the blocks alike.  The partition
//   depends on col_ptr alone, so it is computed once, when the copy is
//   built (ops/kernels.py sorted_colsum_tiles): `tiles[b]` is the number
//   of columns that end before block b's first item.
// - Streams.  A block stages its slots' products and its column ends in
//   shared memory: rows and vals are read 16 bytes at a time with the
//   evict-first hint (__ldcs), col_ptr likewise; all of a thread's stream
//   loads are issued before its gathers of r, which go through the
//   read-only path (__ldg).
// - Sums.  A thread walks kItems merged items with one float64 running
//   sum; a column that ends in the thread's reach and began in it is
//   written there and then.  The column open at each thread's start is
//   finished by a segmented scan of the threads' running sums in shared
//   memory.  A column that crosses a block boundary leaves a float64
//   partial in carry[] (the column open at the block's end) and head[]
//   (the column open at its start); a second, small launch adds those in
//   block order and writes the column.  Empty columns are written 0 by
//   the same pass, so nothing is zero-filled first.
//
// What limits it (measured on an H100 at the glm-fit shape; PERF.md,
// PR 22): the gathers of r, 1.2e8 at random rows.  The kernel takes ~2.1
// ms (23 % of the bound); with r's rows folded into a window of 20 MB or
// less it takes ~1.5 ms, as PyTorch's own r[rows] over the same rows
// does, so a 40 MB r is held by the L2 only in part and the card's rate
// of scattered 4-byte reads sets the floor.  Cache-policy hints
// (evict_last on r, evict_first on the streams) changed nothing; of 128
// to 512 threads a block and 4 to 12 items a thread, 512 x 4 (kept) was
// ~2 % faster than 256 x 8 and the rest slower.
//
// Launches: two a call (this and the fix-up), where the scatter took five
// (the product, the float64 copy, the zero fill, the scatter, the cast
// back).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Merged items (column ends and slots) a thread walks; a block's tile.
// ops/kernels.py keeps kTile as SORTED_COLSUM_TILE.
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
// Passes of 16-byte loads that cover a tile's slots from a 4-aligned
// start (at most kTile + 3 of them).
constexpr int kPasses = (kTile + 3 + 4 * kThreads - 1) / (4 * kThreads);
constexpr int kFixThreads = 256;

__device__ __forceinline__ int64_t ld_stream(const int64_t* p) {
  return static_cast<int64_t>(__ldcs(reinterpret_cast<const long long*>(p)));
}

__global__ void __launch_bounds__(kThreads)
sorted_colsum_kernel(const float* __restrict__ r,
                     const int32_t* __restrict__ rows,
                     const float* __restrict__ vals,
                     const int64_t* __restrict__ col_ptr,
                     const int64_t* __restrict__ tiles,
                     float* __restrict__ out, double* __restrict__ carry,
                     double* __restrict__ head, int64_t dim, int64_t nnz) {
  __shared__ int32_t ends_s[kTile];   // column ends, less y0
  __shared__ double prod_s[kTile];    // the tile's products, in float64
  __shared__ double scan_s[kThreads];
  __shared__ double warp_v[kWarps];
  __shared__ int32_t warp_f[kWarps];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t total = dim + nnz;
  const int64_t d0 = b * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  // The tile: columns x0 .. x1 - 1 end in it; slots y0 .. y1 - 1 lie in it.
  const int64_t x0 = tiles[b];
  const int64_t x1 = tiles[b + 1];
  const int64_t y0 = d0 - x0;
  const int64_t y1 = d1 - x1;
  const int nx = static_cast<int>(x1 - x0);
  const int ny = static_cast<int>(y1 - y0);

  // Stream in: every load of the tile's slots first, then the gathers.
  const int64_t a0 = y0 & ~static_cast<int64_t>(3);
  int32_t rr[kPasses][4];
  float vv[kPasses][4];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int64_t base = a0 + 4 * (static_cast<int64_t>(p) * kThreads + tid);
    if (base + 4 <= nnz && base < y1) {
      const int4 ri = __ldcs(reinterpret_cast<const int4*>(rows + base));
      const float4 vi = __ldcs(reinterpret_cast<const float4*>(vals + base));
      rr[p][0] = ri.x; rr[p][1] = ri.y; rr[p][2] = ri.z; rr[p][3] = ri.w;
      vv[p][0] = vi.x; vv[p][1] = vi.y; vv[p][2] = vi.z; vv[p][3] = vi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = base + e < y1;
        rr[p][e] = in ? __ldcs(rows + base + e) : 0;
        vv[p][e] = in ? __ldcs(vals + base + e) : 0.0f;
      }
    }
  }
  int64_t ends[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    ends[j] = i < nx ? ld_stream(col_ptr + x0 + 1 + i) : 0;
  }
  float g[kPasses][4];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int64_t base = a0 + 4 * (static_cast<int64_t>(p) * kThreads + tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t s = base + e;
      g[p][e] = (s >= y0 && s < y1) ? __ldg(r + rr[p][e]) : 0.0f;
    }
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int64_t base = a0 + 4 * (static_cast<int64_t>(p) * kThreads + tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t s = base + e;
      if (s >= y0 && s < y1) {
        prod_s[s - y0] = static_cast<double>(__fmul_rn(vv[p][e], g[p][e]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    if (i < nx) ends_s[i] = static_cast<int32_t>(ends[j] - y0);
  }
  __syncthreads();

  // The thread's start on the merge path: (xi column ends, yi slots)
  // consumed before its first item; a column's end comes after its slots.
  const int items = nx + ny;
  const int diag = tid * kItems < items ? tid * kItems : items;
  const int stop = diag + kItems < items ? diag + kItems : items;
  int lo = diag - ny > 0 ? diag - ny : 0;
  int hi = diag < nx ? diag : nx;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends_s[mid] <= diag - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int xi = lo;
  int yi = diag - lo;

  double sum = 0.0;
  double first_v = 0.0;  // the sum up to the thread's first column end
  int first_x = -1;      // that column, less x0 (-1: no end in reach)
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (xi + yi < stop) {
      if (xi < nx && ends_s[xi] <= yi) {
        if (first_x < 0) {
          first_x = xi;
          first_v = sum;
        } else {
          out[x0 + xi] = static_cast<float>(sum);
        }
        sum = 0.0;
        ++xi;
      } else {
        sum += prod_s[yi];
        ++yi;
      }
    }
  }

  // Inclusive segmented scan of the threads' running sums, a segment
  // starting at each thread that ended a column: scan_s[t] is the sum of
  // the column open at thread t's end, from its start in this block.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  double v = sum;
  int f = first_x >= 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double vu = __shfl_up_sync(0xffffffffu, v, off);
    const int fu = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) {
      if (!f) v = vu + v;
      f |= fu;
    }
  }
  if (lane == 31) {
    warp_v[warp] = v;
    warp_f[warp] = f;
  }
  __syncthreads();
  if (!f && warp > 0) {
    double before = 0.0;
    for (int w = 0; w < warp; ++w) {
      before = warp_f[w] ? warp_v[w] : before + warp_v[w];
    }
    v = before + v;
  }
  scan_s[tid] = v;
  __syncthreads();

  if (first_x >= 0) {
    const double whole = tid > 0 ? scan_s[tid - 1] + first_v : first_v;
    if (first_x == 0 && b > 0) {
      head[b] = whole;  // column x0 may have begun in an earlier block
    } else {
      out[x0 + first_x] = static_cast<float>(whole);
    }
  }
  if (tid == kThreads - 1) carry[b] = v;
}

// For each block b > 0 in which the column open at its start (tiles[b])
// ends: that column's partials of the blocks before (their carries) and
// of block b (its head), added in block order, written once.
__global__ void __launch_bounds__(kFixThreads)
sorted_colsum_fixup_kernel(const int64_t* __restrict__ tiles,
                           const double* __restrict__ carry,
                           const double* __restrict__ head,
                           float* __restrict__ out, int64_t n_tiles) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kFixThreads + threadIdx.x + 1;
  if (b >= n_tiles) return;
  const int64_t x0 = tiles[b];
  if (tiles[b + 1] == x0) return;
  // Blocks i < b with tiles[i + 1] == x0 hold partials of column x0.
  int64_t lo = b - 1;
  if (tiles[lo] == x0) {
    int64_t a = 0;
    int64_t z = lo;
    while (a < z) {
      const int64_t mid = (a + z) >> 1;
      if (tiles[mid] < x0) {
        a = mid + 1;
      } else {
        z = mid;
      }
    }
    lo = a > 0 ? a - 1 : 0;
  }
  // Four running sums, slot i into sum (i - lo) % 4, joined in one order.
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int64_t i = lo;
  for (; i + 4 <= b; i += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += carry[i + e];
  }
  for (int e = 0; i < b; ++i, ++e) acc[e] += carry[i];
  out[x0] = static_cast<float>(((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                               head[b]);
}

}  // namespace

// Launches the kernel and its fix-up on `stream` (a cudaStream_t of
// `device`, passed as void*) and returns the first failing launch's
// status; it neither synchronises nor allocates, and leaves the calling
// thread's current device as it found it.  rows and vals must be 16-byte
// aligned; tile_items must be this source's kTile, n_tiles the number of
// its tiles over dim + nnz items, and tiles [n_tiles + 1] their
// partition; carry and head hold n_tiles float64 each (scratch).
extern "C" int sorted_colsum_launch(const float* r, const int32_t* rows,
                                    const float* vals, const int64_t* col_ptr,
                                    const int64_t* tiles, float* out,
                                    double* carry, double* head, int64_t dim,
                                    int64_t nnz, int64_t n_tiles,
                                    int32_t tile_items, int32_t device,
                                    void* stream) {
  if (dim <= 0) return static_cast<int>(cudaSuccess);
  if (tile_items != kTile || nnz < 0 ||
      n_tiles != (dim + nnz + kTile - 1) / kTile ||
      n_tiles > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(rows) |
        reinterpret_cast<uintptr_t>(vals)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&r, &rows, &vals, &col_ptr, &tiles,
                  &out, &carry, &head, &dim, &nnz};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(sorted_colsum_kernel),
                         dim3(static_cast<unsigned int>(n_tiles)),
                         dim3(kThreads), args, 0, s);
  if (err == cudaSuccess && n_tiles > 1) {
    void* fix_args[] = {&tiles, &carry, &head, &out, &n_tiles};
    const int64_t fix_blocks = (n_tiles - 1 + kFixThreads - 1) / kFixThreads;
    err = cudaLaunchKernel(
        reinterpret_cast<const void*>(sorted_colsum_fixup_kernel),
        dim3(static_cast<unsigned int>(fix_blocks)), dim3(kFixThreads),
        fix_args, 0, s);
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
