// ELL-level neighbour aggregation for Hopper (sm_90a).
//
// Replaces: neutronstarlite_tpu/ops/pallas_kernels.py::_ell_level_kernel
// (launched per degree bucket by ell_aggregate_pallas). For one ELL level
// [n_rows, K] it computes
//     out[rows_vertex[r]] = cast_to_x_dtype( sum_k wgt[r,k] * x[nbr[r,k]] )
// with f32 products and an f32 sum, one cast at the end; padding slots hold
// index 0 and weight 0. The backward is this kernel over the CSR tables.
//
// Bound on the H100: bytes. A level reads its table slots (8 B each: int32
// index + f32 weight), gathers one x row per slot and writes one output row
// per table row; the work is 2 flops per slot and column, far below the
// card's 67 TFLOP/s f32 for f up to ~600, so the time floor is those bytes
// over 3.35 TB/s.
//
// Design against that bound:
// - a warp owns one table row and a 128-column chunk of it; lane l holds
//   columns l, l+32, l+64, l+96, so each gathered x row is read by
//   consecutive lanes at consecutive addresses (coalesced) and the
//   accumulators stay in registers (no shared memory, no atomics);
// - the warp loads 32 (index, weight) slots at once, one per lane, and
//   broadcasts them with __shfl_sync, so the table is read once, coalesced;
// - the result is written straight to out[rows_vertex[r]], which saves the
//   separate inverse-permutation pass of the JAX executor;
// - hub levels (few rows, K up to ~2^21 on the power-law graphs) are split
//   over K: blockIdx.z takes a contiguous slot range, f32 partials go to a
//   scratch buffer the wrapper allocates, and a second small kernel sums the
//   partials in split order, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 4;
constexpr int kChunk = 32 * kColsPerLane;  // columns per warp
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void ell_level_kernel(const int* __restrict__ nbr,
                                 const float* __restrict__ wgt,
                                 const T* __restrict__ x,
                                 const int* __restrict__ rows_vertex,
                                 T* __restrict__ out,
                                 float* __restrict__ scratch,
                                 int n_rows, int K, int f, int k_per_split) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const int col0 = blockIdx.y * kChunk + lane;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int64_t base = (int64_t)row * K;

  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;

  for (int kb = k_lo; kb < k_hi; kb += 32) {
    int my_nbr = 0;
    float my_w = 0.f;
    if (kb + lane < k_hi) {
      my_nbr = nbr[base + kb + lane];
      my_w = wgt[base + kb + lane];
    }
    const int n = min(32, k_hi - kb);
    for (int j = 0; j < n; ++j) {
      const int u = __shfl_sync(0xffffffffu, my_nbr, j);
      const float w = __shfl_sync(0xffffffffu, my_w, j);
      const T* xr = x + (int64_t)u * f;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = col0 + c * 32;
        if (col < f) acc[c] += w * to_f32(xr[col]);
      }
    }
  }

  if (gridDim.z == 1) {
    T* o = out + (int64_t)rows_vertex[row] * f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = col0 + c * 32;
      if (col < f) o[col] = from_f32<T>(acc[c]);
    }
  } else {
    float* s = scratch + ((int64_t)blockIdx.z * n_rows + row) * f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = col0 + c * 32;
      if (col < f) s[col] = acc[c];
    }
  }
}

// sums the split-K partials in split order (deterministic), casts once
template <typename T>
__global__ void ell_split_reduce(const float* __restrict__ scratch,
                                 const int* __restrict__ rows_vertex,
                                 T* __restrict__ out, int n_rows, int f,
                                 int splits) {
  const int64_t total = (int64_t)n_rows * f;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += scratch[(int64_t)p * total + i];
  const int64_t row = i / f, col = i - row * f;
  out[(int64_t)rows_vertex[row] * f + col] = from_f32<T>(s);
}

template <typename T>
void launch(const int* nbr, const float* wgt, const T* x, const int* rows_vertex,
            T* out, float* scratch, int n_rows, int K, int f, int splits,
            cudaStream_t stream) {
  const int warps = n_rows < kWarpsPerBlock ? n_rows : kWarpsPerBlock;
  const dim3 block(32 * warps);
  const dim3 grid((n_rows + warps - 1) / warps, (f + kChunk - 1) / kChunk, splits);
  const int k_per_split = (K + splits - 1) / splits;
  ell_level_kernel<T><<<grid, block, 0, stream>>>(nbr, wgt, x, rows_vertex, out,
                                                  scratch, n_rows, K, f, k_per_split);
  if (splits > 1) {
    const int64_t total = (int64_t)n_rows * f;
    const int threads = 256;
    ell_split_reduce<T><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                          stream>>>(scratch, rows_vertex, out, n_rows, f, splits);
  }
}

}  // namespace

// feature columns one warp covers (the wrapper's split-K policy reads it)
extern "C" int nts_ell_level_cols() { return kChunk; }

// nbr/rows_vertex int32, wgt/scratch f32, x/out f32 or bf16 (is_bf16);
// scratch holds splits * n_rows * f floats when splits > 1 (else unused).
extern "C" int nts_ell_level(const void* nbr, const void* wgt, const void* x,
                             const void* rows_vertex, void* out, void* scratch,
                             int n_rows, int K, int f, int splits, int is_bf16,
                             void* stream) {
  if (n_rows <= 0 || K <= 0 || f <= 0) return 0;
  if (splits < 1) splits = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>((const int*)nbr, (const float*)wgt,
                          (const __nv_bfloat16*)x, (const int*)rows_vertex,
                          (__nv_bfloat16*)out, (float*)scratch, n_rows, K, f,
                          splits, s);
  } else {
    launch<float>((const int*)nbr, (const float*)wgt, (const float*)x,
                  (const int*)rows_vertex, (float*)out, (float*)scratch, n_rows,
                  K, f, splits, s);
  }
  return (int)cudaGetLastError();
}
