// ELL neighbour aggregation for Hopper (sm_90a): every degree level in one launch.
//
// Replaces: neutronstarlite_tpu/ops/pallas_kernels.py::_ell_level_kernel
// (launched per degree level by ell_aggregate_pallas). For every row r of
// every ELL level [n_rows, K] it computes
//     out[rows_vertex[r]] = cast_to_x_dtype( sum_k wgt[r,k] * x[nbr[r,k]] )
// with f32 weights, f32 products and an f32 sum, one cast at the end. A
// row's live slots are the prefix [0, deg[r]); the rest is padding (index 0,
// weight 0), which adds nothing and is not walked. The backward is this
// kernel over the CSR tables.
//
// Bound on the H100. By the graph alone the work is bytes (tables, x once,
// out once) against 2 flops per edge and column; what the kernel must move
// in practice is one gathered x row piece per live slot, E*f*2 B (bf16),
// through L2. The gathers are latency bound unless many are in flight.
//
// Design:
// - one launch over all levels. The wrapper builds a work list on the host
//   (ops/ell_kernel.py ell_work): items (level, row, slot range, target)
//   over the rows' live slots only, a row longer than the cap cut into
//   near-equal slot ranges, heaviest item first, so the longest items start
//   in the first wave. One warp per (128-column chunk, item), chunk-major:
//   the warps that run together gather from one column slab of x. The
//   levels' own nbr/wgt tables are read through a small device array of
//   per-level base pointers and K; nothing is copied;
// - a lane owns 4 adjacent columns. The warp loads 32 slots (index,
//   weight) at once, one per lane, coalesced, and loads the next 32 before
//   the current ones gather; it then broadcasts the slots with __shfl_sync
//   and issues the x-row gathers of 8 slots before any is consumed, as one
//   16 B (f32) or 8 B (bf16) vector per lane when f % 4 == 0, as two halves
//   when f % 2 == 0 (f = 602 rows start 4-byte aligned), else per column;
// - combine without atomics: an item that is a whole row writes its cast
//   sum straight to out[vertex]; the pieces of a split row write f32
//   partials to a scratch row each, and a second kernel sums each split
//   row's partials in piece order and casts once. A call is one launch, or
//   two when a row splits, and two calls give bitwise equal results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // small CTAs: a CTA's slot frees as soon as its 4 items end
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;
constexpr int kChunk = 32 * kColsPerLane;  // columns per warp
constexpr int kInFlight = 8;               // slots whose gathers are issued together
constexpr int kMinCtasPerSm = 6;           // register cap: 80 per thread
constexpr int kItemInts = 5;               // (level, row, lo, hi, target)
// work-list geometry (read by the wrapper's ell_work): the cap on one
// item's slots lies in [kMinCap, kMaxCap], chosen so that the launch's
// warps (items x column chunks) number about kTargetWarps, a little under
// the 132 SMs x 24-32 warps resident at once: an item is then at most
// ~1.4 times a resident warp's share of the work. Longer items made the
// heaviest one the tail; shorter ones, more split rows, were slower too
// (PERF.md)
constexpr int kMaxCap = 4096;
constexpr int kMinCap = 128;
constexpr int kTargetWarps = 3072;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V adjacent columns of T, loaded by one instruction
template <typename T, int V> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

// a bf16 is the high half of the f32 with the same value; the element at
// the lower address sits in the low half of a little-endian word
__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void unpack(float4 r, float* o) {
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
__device__ __forceinline__ void unpack(float2 r, float* o) { o[0] = r.x; o[1] = r.y; }
__device__ __forceinline__ void unpack(float r, float* o) { o[0] = r; }
__device__ __forceinline__ void unpack(uint2 r, float* o) {
  o[0] = bf16_lo(r.x); o[1] = bf16_hi(r.x); o[2] = bf16_lo(r.y); o[3] = bf16_hi(r.y);
}
__device__ __forceinline__ void unpack(unsigned int r, float* o) {
  o[0] = bf16_lo(r); o[1] = bf16_hi(r);
}
__device__ __forceinline__ void unpack(unsigned short r, float* o) {
  o[0] = __uint_as_float((unsigned int)r << 16);
}

// levels: [n_levels, 3] int64 (nbr base pointer, wgt base pointer, K);
// work: [n_items, 5] int32 (level, row, lo, hi, target), target >= 0 the
// output vertex, target < 0 the scratch row -1 - target
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
ell_work_kernel(const long long* __restrict__ levels, const int* __restrict__ work,
                int n_items, const T* __restrict__ x, T* __restrict__ out,
                float* __restrict__ scratch, int f) {
  using RawT = typename Raw<T, V>::type;
  constexpr int kLoads = kColsPerLane / V;  // loads per slot and lane
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int chunks = (f + kChunk - 1) / kChunk;
  if (w >= (int64_t)n_items * chunks) return;  // warp-uniform; the kernel has no barrier
  const int chunk = (int)(w / n_items);
  const int64_t item = w - (int64_t)chunk * n_items;

  const int* it = work + item * kItemInts;
  const int level = __ldg(it), row = __ldg(it + 1), lo = __ldg(it + 2);
  const int hi = __ldg(it + 3), target = __ldg(it + 4);
  const long long* lv = levels + 3 * level;
  const int64_t base = (int64_t)row * __ldg(lv + 2);
  const int* __restrict__ nbr = reinterpret_cast<const int*>(__ldg(lv)) + base;
  const float* __restrict__ wgt = reinterpret_cast<const float*>(__ldg(lv + 1)) + base;

  const int col0 = chunk * kChunk + lane * kColsPerLane;
  bool col_ok[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) col_ok[l] = col0 + l * V < f;
  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;

  int next_n = 0;
  float next_w = 0.f;
  if (lo + lane < hi) {
    next_n = __ldg(nbr + lo + lane);
    next_w = __ldg(wgt + lo + lane);
  }
  for (int g = lo; g < hi; g += 32) {
    const int my_n = next_n;
    const float my_w = next_w;
    next_n = 0;
    next_w = 0.f;
    if (g + 32 + lane < hi) {  // the next 32 slots load while these gather
      next_n = __ldg(nbr + g + 32 + lane);
      next_w = __ldg(wgt + g + 32 + lane);
    }
    const int n = min(32, hi - g);
    for (int j = 0; j < n; j += kInFlight) {
      RawT raw[kInFlight][kLoads];
      float wq[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int s = __shfl_sync(kFull, my_n, j + q);
        const float ws = __shfl_sync(kFull, my_w, j + q);
        const bool on = j + q < n;
        wq[q] = on ? ws : 0.f;
        const T* xr = x + (int64_t)s * f + col0;
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          raw[q][l] = RawT{};
          if (on && col_ok[l]) raw[q][l] = __ldg(reinterpret_cast<const RawT*>(xr + l * V));
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          float v[V];
          unpack(raw[q][l], v);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[l * V + e] = fmaf(wq[q], v[e], acc[l * V + e]);
        }
      }
    }
  }

  if (target >= 0) {
    T* o = out + (int64_t)target * f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      if (col0 + c < f) o[col0 + c] = from_f32<T>(acc[c]);
  } else {
    float* s = scratch + (int64_t)(-1 - target) * f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      if (col0 + c < f) s[col0 + c] = acc[c];
  }
}

// split row j's partials are scratch rows split_ptr[j]:split_ptr[j+1];
// summed in that (piece) order, cast once, written to out[split_out[j]]
template <typename T>
__global__ void ell_split_reduce(const float* __restrict__ scratch,
                                 const int* __restrict__ split_ptr,
                                 const int* __restrict__ split_out, T* __restrict__ out,
                                 int n_split, int f) {
  const int64_t n = (int64_t)n_split * f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = i / f;
    const int c = (int)(i - j * f);
    float s = 0.f;
    for (int p = __ldg(split_ptr + j); p < __ldg(split_ptr + j + 1); ++p)
      s += scratch[(int64_t)p * f + c];
    out[(int64_t)__ldg(split_out + j) * f + c] = from_f32<T>(s);
  }
}

// f and the alignment of x decide the vector width of a lane's column
// loads (a row of x starts at x + s * f elements)
template <typename T, typename Fn>
cudaError_t with_kernel(int f, uintptr_t x_addr, Fn fn) {
  if (f % 4 == 0 && x_addr % (4 * sizeof(T)) == 0) return fn(ell_work_kernel<T, 4>);
  if (f % 2 == 0 && x_addr % (2 * sizeof(T)) == 0) return fn(ell_work_kernel<T, 2>);
  return fn(ell_work_kernel<T, 1>);
}

template <typename T>
cudaError_t launch(const long long* levels, const int* work, int n_items,
                   const int* split_ptr, const int* split_out, int n_split, const T* x,
                   T* out, float* scratch, int f, cudaStream_t stream) {
  if (n_items > 0) {
    const int64_t warps = (int64_t)n_items * ((f + kChunk - 1) / kChunk);
    const unsigned ctas = (unsigned)((warps + kWarps - 1) / kWarps);
    const cudaError_t e = with_kernel<T>(f, (uintptr_t)x, [&](auto kernel) {
      kernel<<<ctas, kThreads, 0, stream>>>(levels, work, n_items, x, out, scratch, f);
      return cudaGetLastError();
    });
    if (e != cudaSuccess) return e;
  }
  if (n_split > 0) {
    const int64_t want = ((int64_t)n_split * f + 255) / 256;
    ell_split_reduce<T><<<(unsigned)(want < 4096 ? want : 4096), 256, 0, stream>>>(
        scratch, split_ptr, split_out, out, n_split, f);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// feature columns one warp covers
extern "C" int nts_ell_level_cols() { return kChunk; }

// the geometry the wrapper's work list and checks read: [largest cap,
// least cap, target warps, warps per CTA]
extern "C" int nts_ell_level_geometry(int* g) {
  g[0] = kMaxCap;
  g[1] = kMinCap;
  g[2] = kTargetWarps;
  g[3] = kWarps;
  return 0;
}

// occupancy of the kernel instance for (dtype, f), x aligned: [CTAs per SM
// from the occupancy API, registers per thread, shared bytes per CTA,
// local (spill) bytes per thread]; returns the cudaError_t
extern "C" int nts_ell_level_occupancy(int is_bf16, int f, int* o) {
  auto query = [&](auto kernel) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    o[1] = a.numRegs;
    o[2] = (int)a.sharedSizeBytes;
    o[3] = (int)a.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel, kThreads, 0);
  };
  return (int)(is_bf16 ? with_kernel<__nv_bfloat16>(f, 0, query)
                       : with_kernel<float>(f, 0, query));
}

// levels [n_levels, 3] int64, work [n_items, 5] / split_ptr [n_split + 1] /
// split_out [n_split] int32, x [V, f] and out [V, f] f32 or bf16 (is_bf16),
// scratch [split_ptr[n_split], f] f32. Two kernels: the work items (when
// there is one) and the split rows' reduction (when a row splits).
extern "C" int nts_ell_level(const void* levels, const void* work, int n_items,
                             const void* split_ptr, const void* split_out, int n_split,
                             const void* x, void* out, void* scratch, int f, int is_bf16,
                             void* stream) {
  if (f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    e = launch<__nv_bfloat16>((const long long*)levels, (const int*)work, n_items,
                              (const int*)split_ptr, (const int*)split_out, n_split,
                              (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
                              (float*)scratch, f, s);
  } else {
    e = launch<float>((const long long*)levels, (const int*)work, n_items,
                      (const int*)split_ptr, (const int*)split_out, n_split,
                      (const float*)x, (float*)out, (float*)scratch, f, s);
  }
  return (int)e;
}
