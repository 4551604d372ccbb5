// GAT's attention-weight gradient over the ELL work list, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this function in plain
// jnp (neutronstarlite_tpu/ops/ell_gat.py::_grad_alpha_level), and so did the
// port (ops/ell_gat.py::grad_alpha_level, kept as the plain version). That
// plain version, a [rows, slots, f] gather and a bmm per level and piece
// (1,792 launches per epoch), took 68 % of GAT's device time on a
// Reddit-size graph (PERF.md). It is an SDDMM: for every live slot (l, r, k)
// of the forward (CSC) ELL tables
//     out[base_l + r * K_l + k] = sum_j g[rows_vertex_l[r], j] * h[nbr_l[r, k], j]
// in f32 (g, h and the output; GAT's trainers run f32, and a bf16 load path
// waits for a bf16 GAT trainer). Padding slots are not walked: the wrapper
// zero-fills the flat output once.
//
// Bound on the H100. By the counts the work is 2 E f operations over
// 67 TFLOP/s of f32 (about 0.6 ms per GAT epoch on Reddit) against g and h
// read once, the slot indices (4 B per live slot) and the output (4 B per
// slot) over HBM. What the kernel must move in practice is one gathered h
// row per live slot, E * f * 4 B through L2, as the forward aggregation
// does: the gathers are latency bound unless many are in flight.
//
// Design:
// - one launch per call, over the forward aggregation's own cached work list
//   at the same width (ops/ell_kernel.py work_list): items (level, row, slot
//   range) over the live slots only, a row longer than the cap cut into
//   pieces, heaviest first. Each slot's output is its own, so a split row's
//   pieces need no reduction and no atomics (their target is ignored), and
//   two calls give bitwise equal results. One warp per item;
// - a level array built once at set-up holds each level's (nbr pointer,
//   rows_vertex pointer, flat slot base, K): no per-call copy;
// - LPS lanes serve one slot, LPS chosen from f (the fewest power-of-two
//   lanes that cover f with 4 columns each, at most 32), so the warp serves
//   32 / LPS slots at once and at f 41 no lane is idle for a whole slot; a
//   row wider than 4 * 32 columns takes several column chunks, the sums
//   carried in registers;
// - the item's g row is loaded once (per chunk) into registers; the warp
//   loads 32 slot indices at once, one per lane, coalesced, and the next 32
//   while these gather; it broadcasts them with __shfl_sync and issues the
//   h gathers of 4 steps, each step 32 / LPS slots, before any is consumed,
//   as one 16 B vector per lane when f % 4 == 0, as halves when
//   f % 2 == 0, else per column;
// - each lane keeps one partial dot per step; a transpose-reduce across the
//   LPS lanes of a slot (LPS - 1 shuffles per lane for 32 slots, in place of
//   log2(LPS) per slot) leaves lane j of each slot group with step j's whole
//   dot, so the 32 slots of a group are written by 32 lanes at once.
//
// The vector-load helpers repeat ell_level.cu's: that file stays one source
// and one build for the aggregation alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // small CTAs, as ell_level's: a slot frees when its 4 items end
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;  // columns of one slot's row a lane covers per chunk
// steps whose gathers are issued together: 64 bytes per lane in flight (at
// Reddit size 8 steps ran f 41 27 % slower and f 128 no faster; PERF.md)
constexpr int kInFlight = 4;
constexpr int kMinCtasPerSm = 6;  // register cap: 80 per thread, no spill
constexpr int kItemInts = 5;   // (level, row, lo, hi, target)
constexpr int kLevelInts = 4;  // (nbr pointer, rows_vertex pointer, flat slot base, K)
constexpr unsigned kFull = 0xffffffffu;

// V adjacent f32 columns, loaded by one instruction
template <int V> struct Raw;
template <> struct Raw<4> { using type = float4; };
template <> struct Raw<2> { using type = float2; };
template <> struct Raw<1> { using type = float; };

__device__ __forceinline__ void unpack(float4 r, float* o) {
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
__device__ __forceinline__ void unpack(float2 r, float* o) { o[0] = r.x; o[1] = r.y; }
__device__ __forceinline__ void unpack(float r, float* o) { o[0] = r; }

// v[0..N) in each lane -> the lane's value (lane / STRIDE) % N summed over
// the N lanes lane ^ (m * STRIDE), m < N; N - 1 shuffles per lane
template <int N, int STRIDE>
__device__ __forceinline__ float transpose_reduce(float* v, int lane) {
#pragma unroll
  for (int o = N / 2; o >= 1; o /= 2) {
    const bool upper = lane & (o * STRIDE);
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o * STRIDE);
    }
  }
  return v[0];
}

// levels: [n_levels, 4] int64 (nbr base pointer, rows_vertex base pointer,
// flat slot base, K); work: [n_items, 5] int32 (level, row, lo, hi, target);
// out: the flat f32 slots of all levels. Subgroup `sub` of LPS lanes takes
// slot t * (32 / LPS) + sub of a group of 32 at step t; lane j of it covers
// columns (l * LPS + j) * V .. + V of each chunk, l < 4 / V.
template <int V, int LPS>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
gat_grad_alpha_kernel(const long long* __restrict__ levels, const int* __restrict__ work,
                      int n_items, const float* __restrict__ g, const float* __restrict__ h,
                      float* __restrict__ out, int f) {
  using RawT = typename Raw<V>::type;
  constexpr int kLoads = kColsPerLane / V;  // loads per slot, lane and chunk
  constexpr int kSub = 32 / LPS;            // slots one step serves
  constexpr int kB = LPS < kInFlight ? LPS : kInFlight;  // steps per batch
  constexpr int kBatches = LPS / kB;
  constexpr int kWidth = LPS * kColsPerLane;  // columns per chunk
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPS, j = lane % LPS;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // warp-uniform; the kernel has no barrier

  const int* it = work + item * kItemInts;
  const int level = __ldg(it), row = __ldg(it + 1), lo = __ldg(it + 2), hi = __ldg(it + 3);
  const long long* lv = levels + kLevelInts * level;
  const int64_t base = (int64_t)row * __ldg(lv + 3);
  const int* __restrict__ nbr = reinterpret_cast<const int*>(__ldg(lv)) + base;
  const int vertex = __ldg(reinterpret_cast<const int*>(__ldg(lv + 1)) + row);
  float* __restrict__ o = out + __ldg(lv + 2) + base;
  const int chunks = (f + kWidth - 1) / kWidth;

  float gq[kColsPerLane];  // this lane's columns of g[vertex] in the current chunk
  auto load_g_chunk = [&](int c) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = c * kWidth + (l * LPS + j) * V + e;
        gq[l * V + e] = col < f ? __ldg(g + (int64_t)vertex * f + col) : 0.f;
      }
  };
  load_g_chunk(0);

  int next_n = 0;
  if (lo + lane < hi) next_n = __ldg(nbr + lo + lane);
  for (int g0 = lo; g0 < hi; g0 += 32) {
    const int my_n = next_n;
    next_n = 0;
    if (g0 + 32 + lane < hi) next_n = __ldg(nbr + g0 + 32 + lane);  // loads while these gather
    const int n = min(32, hi - g0);
    float bsum[kBatches];
#pragma unroll
    for (int b = 0; b < kBatches; ++b) {
      bsum[b] = 0.f;
      if (b * kB * kSub >= n) continue;  // warp-uniform: no live slot in this batch
      float p[kB];
#pragma unroll
      for (int q = 0; q < kB; ++q) p[q] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        if (chunks > 1) load_g_chunk(c);
        const int cbase = c * kWidth + j * V;
        RawT raw[kB][kLoads];
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          const int s = (b * kB + q) * kSub + sub;
          const int idx = __shfl_sync(kFull, my_n, s);
          const float* hr = h + (int64_t)idx * f + cbase;
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            raw[q][l] = RawT{};
            if (s < n && cbase + l * LPS * V < f)
              raw[q][l] = __ldg(reinterpret_cast<const RawT*>(hr + l * LPS * V));
          }
        }
#pragma unroll
        for (int q = 0; q < kB; ++q)
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            float x[V];
            unpack(raw[q][l], x);
#pragma unroll
            for (int e = 0; e < V; ++e) p[q] = fmaf(gq[l * V + e], x[e], p[q]);
          }
      }
      bsum[b] = transpose_reduce<kB, 1>(p, lane);  // lane j: step b * kB + j % kB
    }
    const float dot = transpose_reduce<kBatches, kB>(bsum, lane);  // lane j: step j
    const int s = j * kSub + sub;
    if (s < n) o[g0 + s] = dot;
  }
}

template <int V, typename Fn>
cudaError_t with_lanes(int f, Fn fn) {
  const int need = (f + kColsPerLane - 1) / kColsPerLane;  // lanes at 4 columns each
  if (need <= 1) return fn(gat_grad_alpha_kernel<V, 1>);
  if (need <= 2) return fn(gat_grad_alpha_kernel<V, 2>);
  if (need <= 4) return fn(gat_grad_alpha_kernel<V, 4>);
  if (need <= 8) return fn(gat_grad_alpha_kernel<V, 8>);
  if (need <= 16) return fn(gat_grad_alpha_kernel<V, 16>);
  return fn(gat_grad_alpha_kernel<V, 32>);
}

// f and the alignment of h decide the vector width of a lane's column
// loads (a row of h starts at h + s * f elements), f the lanes per slot
template <typename Fn>
cudaError_t with_kernel(int f, uintptr_t h_addr, Fn fn) {
  if (f % 4 == 0 && h_addr % (4 * sizeof(float)) == 0) return with_lanes<4>(f, fn);
  if (f % 2 == 0 && h_addr % (2 * sizeof(float)) == 0) return with_lanes<2>(f, fn);
  return with_lanes<1>(f, fn);
}

}  // namespace

// levels [n_levels, 4] int64, work [n_items, 5] int32, g [V, f] and
// h [n_src, f] f32, out the flat f32 slots of all forward levels,
// zero-filled by the caller. One kernel when there is an item.
extern "C" int nts_ell_gat_grad_alpha(const void* levels, const void* work, int n_items,
                                      const void* g, const void* h, void* out, int f,
                                      void* stream) {
  if (f <= 0 || n_items <= 0) return 0;
  const unsigned ctas = (unsigned)(((int64_t)n_items + kWarps - 1) / kWarps);
  return (int)with_kernel(f, (uintptr_t)h, [&](auto kernel) {
    kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        (const long long*)levels, (const int*)work, n_items, (const float*)g,
        (const float*)h, (float*)out, f);
    return cudaGetLastError();
  });
}
