// gather_rowsum: out[i] = sum_k vals[i,k] * table[ids[i,k]]
//
// Replaces photon_ml_tpu/ops/kernels.py::_pallas_gather_rowsum, the
// Pallas kernel for the padded-ELL gather-contract.  On the TPU that
// kernel only ran in interpret mode (Mosaic cannot lower table_ref[ids]);
// Hopper gathers straight from device memory, so here it is the live
// kernel of the serving path's sparse fixed-effect term.
//
// Bound: bytes.  Each row streams k float values and k int32 ids
// (n*k*8 bytes) and writes one float (n*4 bytes); the table reads hit the
// distinct ids only, and a 400 KB table stays resident in the 50 MB L2.
// The arithmetic (2*n*k flops) is far below the fp32 rate.  At the
// serving bucket (64 x 32) the launch latency dominates everything.
//
// Design (simple first): one warp per row, 8 rows per 256-thread block.
// The 32 lanes stride over k, so the loads of vals and ids are coalesced;
// table entries go through the read-only cache (__ldg).  Each lane keeps
// a float32 partial sum, a __shfl_down_sync tree folds the warp, and
// lane 0 stores.  Padding slots (id 0, val 0) are multiplied, not
// skipped, which keeps the JAX semantics exactly (0 * inf = NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
gather_rowsum_kernel(const float* __restrict__ table,
                     const float* __restrict__ vals,
                     const int32_t* __restrict__ ids,
                     float* __restrict__ out, int64_t n, int32_t k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // The whole warp shares one row, so it leaves together and the
  // shuffles below always run on a full warp.
  if (row >= n) return;
  const float* v = vals + row * k;
  const int32_t* id = ids + row * k;
  float acc = 0.0f;
  for (int j = lane; j < k; j += 32) {
    acc = fmaf(__ldg(v + j), __ldg(table + __ldg(id + j)), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as void*) and returns the
// launch status; it neither synchronises nor allocates.
extern "C" int gather_rowsum_launch(const float* table, const float* vals,
                                    const int32_t* ids, float* out,
                                    int64_t n, int32_t k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rowsum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, vals, ids, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
