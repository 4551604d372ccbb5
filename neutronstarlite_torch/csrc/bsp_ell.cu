// Block-sparse (dst tile, src tile) neighbour aggregation for Hopper (sm_90a).
//
// Replaces: neutronstarlite_tpu/ops/bsp_ell.py::_bsp_kernel (launched by
// _bsp_call). The tables pack the edges into blocks of K slots x R rows,
// each block belonging to one (dst tile of dt rows, src tile of vt rows):
//     out[dt*d + ldst[b,r]] += sum_k round_to_x_dtype(wgt[b,k,r])
//                                    * x[vt*s + nbr[b,k,r]]
// for every block b of dst tile d with src tile s (blk_key[b] = d*t_src + s),
// f32 accumulation across all of the tile's blocks and one cast to x's
// dtype at the end. Padding slots and rows carry weight 0. The backward is
// this kernel over the CSR tables.
//
// Bound on the H100: bytes. The tables are 8 B per slot (int32 index + f32
// weight) plus 4 B per row (ldst); x is read and [V, f] written; the work is
// 2 flops per slot and column, well under the 67 TFLOP/s f32 rate, so the
// floor is those bytes over 3.35 TB/s.
//
// Design against that bound:
// - the TPU kernel turned the gather and the scatter into two one-hot
//   matrix products because Mosaic has no row gather; Hopper gathers rows
//   natively, so both products are gone: rows of x are read straight from
//   global memory and the row sums are added into the tile accumulator;
// - one CTA per (64-column feature chunk, dst tile) walks that tile's
//   blocks (a [t_dst+1] block-range array built with the tables) with an
//   f32 [dt, 64] accumulator in shared memory (128 KB at dt=512, dynamic
//   shared memory above 48 KB after cudaFuncSetAttribute); the chunks of
//   one tile are launched next to each other, so they share its tables in
//   L2;
// - a warp takes 32 packed rows of a block at a time: lane l loads row l's
//   K slots (coalesced across the warp, rounding each weight to x's dtype
//   once), then the warp walks the 32 rows, broadcasting each row's slots
//   with __shfl_sync; every lane owns columns lane and lane+32, so each
//   gathered x row is read at consecutive addresses, and the K x 2 gathers
//   of a row are independent loads in flight together;
// - a slot of weight 0 (block padding, 1.5-3x of the slots on the
//   power-law graphs) gathers nothing and a row of such slots only is
//   skipped, so padding costs its table bytes and no x traffic (for finite
//   x this is exactly the plain version's 0 * x); a row sum lands in the
//   accumulator with
//   one shared-memory atomicAdd per column (several rows of a block may
//   share an ldst when a destination's run is longer than K, so the adds
//   must be atomic);
// - each tile is written once; a tile with no blocks writes zeros.
// Shared atomics make the f32 summation order vary from run to run: results
// agree with the plain version to f32 rounding, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 2;
constexpr int kCols = 32 * kColsPerLane;  // feature columns per CTA
constexpr int kWarps = 16;
constexpr int kSlots = 8;  // slots of a row held in registers per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
bsp_ell_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
               const int* __restrict__ ldst, const int* __restrict__ blk_key,
               const int* __restrict__ tile_ptr, const T* __restrict__ x,
               T* __restrict__ out, int t_src, int dt, int vt, int K, int R,
               int n_src, int v_num, int f) {
  extern __shared__ float acc_tile[];  // [dt][kCols]
  const int chunk = blockIdx.x;
  const int tile = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = chunk * kCols + lane;

  for (int i = threadIdx.x; i < dt * kCols; i += blockDim.x) acc_tile[i] = 0.f;
  __syncthreads();

  const int b_lo = tile_ptr[tile], b_hi = tile_ptr[tile + 1];
  const int groups = (R + 31) / 32;  // 32-row groups per block
  const int64_t n_items = (int64_t)(b_hi - b_lo) * groups;
  for (int64_t it = warp; it < n_items; it += kWarps) {
    const int b = b_lo + (int)(it / groups);
    const int r = (int)(it % groups) * 32 + lane;  // this lane's row
    const bool row_ok = r < R;
    const int src_base = (blk_key[b] % t_src) * vt;
    const int my_ldst = row_ok ? ldst[(int64_t)b * R + r] : 0;
    for (int k0 = 0; k0 < K; k0 += kSlots) {
      int my_src[kSlots];
      float my_w[kSlots];
      bool my_any = false;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        my_src[k] = 0;
        my_w[k] = 0.f;
        if (row_ok && k0 + k < K) {
          const int64_t s = ((int64_t)b * K + k0 + k) * R + r;
          const int src = src_base + nbr[s];
          // the weight rounds to x's dtype before the product (TPU policy)
          const float w = to_f32(from_f32<T>(wgt[s]));
          if (src < n_src && w != 0.f) {
            my_src[k] = src;
            my_w[k] = w;
            my_any = true;
          }
        }
      }
      unsigned live = __ballot_sync(0xffffffffu, my_any);
      while (live) {  // rows with a non-zero weight, in lane order
        const int j = __ffs(live) - 1;
        live &= live - 1;
        float v[kSlots][kColsPerLane];
        float w[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int u = __shfl_sync(0xffffffffu, my_src[k], j);
          w[k] = __shfl_sync(0xffffffffu, my_w[k], j);
          const T* xr = x + (int64_t)u * f;
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            const int col = col0 + c * 32;
            v[k][c] = col < f ? to_f32(xr[col]) : 0.f;
          }
        }
        const int d = __shfl_sync(0xffffffffu, my_ldst, j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          float a = 0.f;
#pragma unroll
          for (int k = 0; k < kSlots; ++k) a += w[k] * v[k][c];
          atomicAdd(&acc_tile[d * kCols + lane + c * 32], a);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < dt * kCols; i += blockDim.x) {
    const int64_t v = (int64_t)tile * dt + i / kCols;
    const int c = chunk * kCols + i % kCols;
    if (v < v_num && c < f) out[v * f + c] = from_f32<T>(acc_tile[i]);
  }
}

template <typename T>
cudaError_t launch(const int* nbr, const float* wgt, const int* ldst,
                   const int* blk_key, const int* tile_ptr, const T* x, T* out,
                   int t_dst, int t_src, int dt, int vt, int K, int R,
                   int n_src, int v_num, int f, cudaStream_t stream) {
  const size_t smem = (size_t)dt * kCols * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bsp_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((f + kCols - 1) / kCols, t_dst);
  bsp_ell_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      nbr, wgt, ldst, blk_key, tile_ptr, x, out, t_src, dt, vt, K, R, n_src,
      v_num, f);
  return cudaGetLastError();
}

}  // namespace

// feature columns one CTA covers, the width of its [dt, cols] f32 shared
// accumulator (the wrapper's shared-memory check reads it)
extern "C" int nts_bsp_ell_cols() { return kCols; }

// nbr [B,K,R] / ldst [B,R] / blk_key [B] / tile_ptr [t_dst+1] int32, wgt
// [B,K,R] f32, x [n_src, f] and out [v_num, f] f32 or bf16 (is_bf16).
extern "C" int nts_bsp_ell(const void* nbr, const void* wgt, const void* ldst,
                           const void* blk_key, const void* tile_ptr,
                           const void* x, void* out, int t_dst, int t_src,
                           int dt, int vt, int K, int R, int n_src, int v_num,
                           int f, int is_bf16, void* stream) {
  if (t_dst <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    e = launch<__nv_bfloat16>((const int*)nbr, (const float*)wgt, (const int*)ldst,
                              (const int*)blk_key, (const int*)tile_ptr,
                              (const __nv_bfloat16*)x, (__nv_bfloat16*)out, t_dst,
                              t_src, dt, vt, K, R, n_src, v_num, f, s);
  } else {
    e = launch<float>((const int*)nbr, (const float*)wgt, (const int*)ldst,
                      (const int*)blk_key, (const int*)tile_ptr, (const float*)x,
                      (float*)out, t_dst, t_src, dt, vt, K, R, n_src, v_num, f, s);
  }
  return (int)e;
}
