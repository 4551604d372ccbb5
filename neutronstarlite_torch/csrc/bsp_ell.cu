// Block-sparse (dst tile, src tile) neighbour aggregation for Hopper (sm_90a).
//
// Replaces: neutronstarlite_tpu/ops/bsp_ell.py::_bsp_kernel (launched by
// _bsp_call). The tables pack the edges into blocks of K slots x R rows,
// each block belonging to one (dst tile of dt rows, src tile of vt rows):
//     out[dt*d + ldst[b,r]] += sum_k round_to_x_dtype(wgt[b,k,r])
//                                    * x[vt*s + nbr[b,k,r]]
// for every block b of dst tile d with src tile s (blk_key[b] = d*t_src + s),
// f32 products and sums across all of the tile's blocks and one cast to x's
// dtype at the end. Padding slots and rows carry weight 0. The backward is
// this kernel over the CSR tables.
//
// Bound on the H100. By the graph alone the work is bytes (tables, x once,
// out once) against 2 flops per edge and column; what the kernel must move
// in practice is one gathered x row piece per edge, E*f*2 B (bf16) through
// L2, which is the floor the design works against: the gathers are latency
// bound unless many of them are in flight on every SM.
//
// Design:
// - work is cut into pieces: contiguous ranges of a dst tile's data blocks,
//   built on the host from the tiles' block ranges (ops/bsp_ell.py
//   bsp_pieces), a tile splitting only where the card would not be filled or
//   where it is heavier than the mean tile. One CTA per (128-column chunk,
//   piece), chunk-major, so the CTAs that run together gather from one
//   column slab of x;
// - no shared memory: a CTA's 8 warps each take a contiguous range of the
//   piece's 32-row groups; lane l loads row l's K <= 8 slots (coalesced
//   across the warp, rounding each weight to x's dtype), and the next
//   group's slots are loaded before the current group's rows gather, so the
//   table reads overlap the gathers;
// - the warp walks the live rows (a non-zero weight) two at a time: both
//   rows' slots are broadcast with __shfl_sync and all their gathers are
//   issued before either is consumed (2 x K loads per lane in flight); a
//   lane owns 4 adjacent columns, loaded as one 16 B (f32) or 8 B (bf16)
//   vector when f % 4 == 0, as two halves when f % 2 == 0, else one column
//   at a time (a row of x starts at f * sizeof(T), so the vector width
//   follows the alignment of f); a slot of weight 0 loads nothing;
// - rows are dst-sorted within each (dst tile, src tile) group, so a run of
//   consecutive live rows with the same destination (a destination with
//   more than K edges in one src tile) is summed in registers and added
//   once;
// - combine: a run is added with one 16-byte f32 vector atomic per lane
//   (atomicAdd on float4, sm_90) into an f32 buffer [v_num, fp] (fp = f
//   rounded up to 4) that the launcher zeroes with cudaMemsetAsync; a second
//   kernel casts the buffer to x's dtype. The order of the f32 additions
//   into the buffer varies from run to run, so results agree with the plain
//   version to f32 rounding, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;
constexpr int kCols = 32 * kColsPerLane;  // feature columns per CTA
constexpr int kMaxK = 8;                  // slots of a row held in registers
constexpr int kGroup = 32;                // rows per warp step, one per lane
constexpr int kMinCtasPerSm = 3;          // register cap: 80 per thread
// piece-list geometry (read by the wrapper's bsp_pieces): the CTA count a
// launch aims for (132 SMs x a few CTAs x a few waves) and the least blocks
// a piece holds (8 warps x 32-row groups of R = 128-row blocks)
constexpr int kTargetCtas = 2048;
constexpr int kMinPieceBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the weight rounds to x's dtype before the product (the TPU kernel's policy)
template <typename T> __device__ __forceinline__ float round_w(float w);
template <> __device__ __forceinline__ float round_w<float>(float w) { return w; }
template <> __device__ __forceinline__ float round_w<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16(w));
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

// one lane's row of a 32-row group, as loaded (decoded only when walked)
struct Group {
  int nbr[kMaxK];
  float wgt[kMaxK];
  int ldst;
  int key;
};

__device__ __forceinline__ void load_group(Group& g, const int* __restrict__ nbr,
                                           const float* __restrict__ wgt,
                                           const int* __restrict__ ldst,
                                           const int* __restrict__ blk_key,
                                           int64_t item, int groups, int K, int R,
                                           int lane) {
  const int64_t b = item / groups;
  const int r = (int)(item - b * groups) * kGroup + lane;
  const bool ok = r < R;
  g.key = __ldg(blk_key + b);
  g.ldst = ok ? __ldg(ldst + b * R + r) : 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const bool on = ok && k < K;
    const int64_t s = (b * K + k) * R + r;
    g.nbr[k] = on ? __ldg(nbr + s) : 0;
    g.wgt[k] = on ? __ldg(wgt + s) : 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
bsp_ell_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
               const int* __restrict__ ldst, const int* __restrict__ blk_key,
               const int* __restrict__ piece_ptr, const T* __restrict__ x,
               float* __restrict__ acc_buf, int n_pieces, int t_src, int dt, int vt,
               int K, int R, int n_src, int f, int fp) {
  using RawT = typename Raw<T, V>::type;
  constexpr int kLoads = kColsPerLane / V;  // loads per slot and lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x / n_pieces;
  const int piece = blockIdx.x - chunk * n_pieces;
  const int col0 = chunk * kCols + lane * kColsPerLane;

  // this warp's contiguous share of the piece's 32-row groups
  const int groups = (R + kGroup - 1) / kGroup;
  const int64_t it_begin = (int64_t)piece_ptr[piece] * groups;
  const int64_t it_end = (int64_t)piece_ptr[piece + 1] * groups;
  const int64_t per = (it_end - it_begin + kWarps - 1) / kWarps;
  const int64_t lo = it_begin + warp * per;
  const int64_t hi = lo + per < it_end ? lo + per : it_end;
  if (lo >= hi) return;  // warp-uniform; the kernel has no barrier

  bool col_ok[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) col_ok[l] = col0 + l * V < f;

  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
  int run_dst = -1;  // destination of the run summed in acc
  auto flush = [&]() {
    if (run_dst >= 0 && col0 < f) {
      float* p = acc_buf + (int64_t)run_dst * fp + col0;
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
  };

  Group next;
  load_group(next, nbr, wgt, ldst, blk_key, lo, groups, K, R, lane);
  for (int64_t it = lo; it < hi; ++it) {
    const Group cur = next;
    if (it + 1 < hi) load_group(next, nbr, wgt, ldst, blk_key, it + 1, groups, K, R, lane);

    const int src_base = (cur.key % t_src) * vt;
    const int dst_base = (cur.key / t_src) * dt;
    int my_src[kMaxK];
    float my_w[kMaxK];
    bool my_any = false;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      int s = src_base + cur.nbr[k];
      float w = round_w<T>(cur.wgt[k]);
      if (w == 0.f || s >= n_src) {
        w = 0.f;
        s = 0;
      }
      my_src[k] = s;
      my_w[k] = w;
      my_any |= w != 0.f;
    }

    unsigned live = __ballot_sync(kFull, my_any);
    while (live) {  // live rows in lane order, two at a time
      const int j0 = __ffs(live) - 1;
      live &= live - 1;
      const bool two = live != 0;
      const int j1 = two ? __ffs(live) - 1 : j0;
      if (two) live &= live - 1;

      RawT raw[2][kMaxK][kLoads];
      float w[2][kMaxK];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = q == 0 ? j0 : j1;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int s = __shfl_sync(kFull, my_src[k], j);
          const float wk = __shfl_sync(kFull, my_w[k], j);
          w[q][k] = (q == 0 || two) ? wk : 0.f;
          const T* xr = x + (int64_t)s * f + col0;
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            raw[q][k][l] = RawT{};
            if (w[q][k] != 0.f && col_ok[l])
              raw[q][k][l] = __ldg(reinterpret_cast<const RawT*>(xr + l * V));
          }
        }
      }
      const int d0 = dst_base + __shfl_sync(kFull, cur.ldst, j0);
      const int d1 = dst_base + __shfl_sync(kFull, cur.ldst, j1);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) break;
        const int d = q == 0 ? d0 : d1;
        if (d != run_dst) {
          flush();
          run_dst = d;
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            float v[V];
            unpack(raw[q][k][l], v);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[l * V + e] = fmaf(w[q][k], v[e], acc[l * V + e]);
          }
        }
      }
    }
  }
  flush();
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ acc_buf, T* __restrict__ out,
                            int64_t n, int f, int fp) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t v = i / f;
    out[i] = from_f32<T>(acc_buf[v * fp + (i - v * f)]);
  }
}

// f decides the vector width of a lane's column loads
template <typename T, typename Fn>
cudaError_t with_kernel(int f, Fn fn) {
  if (f % 4 == 0) return fn(bsp_ell_kernel<T, 4>);
  if (f % 2 == 0) return fn(bsp_ell_kernel<T, 2>);
  return fn(bsp_ell_kernel<T, 1>);
}

template <typename T>
cudaError_t launch(const int* nbr, const float* wgt, const int* ldst,
                   const int* blk_key, const int* piece_ptr, const T* x,
                   float* acc_buf, T* out, int n_pieces, int t_src, int dt, int vt,
                   int K, int R, int n_src, int v_num, int f, cudaStream_t stream) {
  const int fp = (f + 3) & ~3;
  cudaError_t e = cudaMemsetAsync(acc_buf, 0, (size_t)v_num * fp * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  if (n_pieces > 0) {
    const unsigned ctas = (unsigned)(((f + kCols - 1) / kCols) * n_pieces);
    e = with_kernel<T>(f, [&](auto kernel) {
      kernel<<<ctas, kThreads, 0, stream>>>(nbr, wgt, ldst, blk_key, piece_ptr, x,
                                            acc_buf, n_pieces, t_src, dt, vt, K, R,
                                            n_src, f, fp);
      return cudaGetLastError();
    });
    if (e != cudaSuccess) return e;
  }
  const int64_t n = (int64_t)v_num * f;
  const int64_t want = (n + 255) / 256;
  cast_kernel<T><<<(unsigned)(want < 4096 ? want : 4096), 256, 0, stream>>>(acc_buf, out, n, f, fp);
  return cudaGetLastError();
}

}  // namespace

// feature columns one CTA covers
extern "C" int nts_bsp_ell_cols() { return kCols; }

// the geometry the wrapper's piece list and checks read: [most slots per
// row, target CTAs, least blocks per piece]
extern "C" int nts_bsp_ell_geometry(int* g) {
  g[0] = kMaxK;
  g[1] = kTargetCtas;
  g[2] = kMinPieceBlocks;
  return 0;
}

// occupancy of the kernel instance for (dtype, f): [CTAs per SM from the
// occupancy API, registers per thread, shared bytes per CTA, local (spill)
// bytes per thread]; returns the cudaError_t
extern "C" int nts_bsp_ell_occupancy(int is_bf16, int f, int* o) {
  auto query = [&](auto kernel) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    o[1] = a.numRegs;
    o[2] = (int)a.sharedSizeBytes;
    o[3] = (int)a.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel, kThreads, 0);
  };
  return (int)(is_bf16 ? with_kernel<__nv_bfloat16>(f, query) : with_kernel<float>(f, query));
}

// nbr [B,K,R] / ldst [B,R] / blk_key [B] / piece_ptr [n_pieces+1] int32, wgt
// [B,K,R] f32, x [n_src, f] and out [v_num, f] f32 or bf16 (is_bf16),
// acc_buf [v_num, round_up(f, 4)] f32 scratch. Two kernels: the aggregation
// (when there is a piece) and the cast.
extern "C" int nts_bsp_ell(const void* nbr, const void* wgt, const void* ldst,
                           const void* blk_key, const void* piece_ptr,
                           const void* x, void* acc_buf, void* out, int n_pieces,
                           int t_src, int dt, int vt, int K, int R, int n_src,
                           int v_num, int f, int is_bf16, void* stream) {
  if (v_num <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    e = launch<__nv_bfloat16>((const int*)nbr, (const float*)wgt, (const int*)ldst,
                              (const int*)blk_key, (const int*)piece_ptr,
                              (const __nv_bfloat16*)x, (float*)acc_buf,
                              (__nv_bfloat16*)out, n_pieces, t_src, dt, vt, K, R,
                              n_src, v_num, f, s);
  } else {
    e = launch<float>((const int*)nbr, (const float*)wgt, (const int*)ldst,
                      (const int*)blk_key, (const int*)piece_ptr, (const float*)x,
                      (float*)acc_buf, (float*)out, n_pieces, t_src, dt, vt, K, R,
                      n_src, v_num, f, s);
  }
  return (int)e;
}
