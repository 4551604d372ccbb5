// Native preprocessing runtime: CSC/CSR graph build + fan-out sampling.
//
// The TPU framework's counterpart of the reference's native preprocessing
// core: Graph::load_directed's adjacency construction (core/graph.hpp:1285-
// 1827), PartitionedGraph::PartitionToChunks' CSC+CSR+weight build
// (core/PartitionedGraph.hpp:324-420), and Sampler::reservoir_sample
// (core/ntsSampler.hpp:113-172). Device compute stays in XLA; this library
// accelerates the host-side, O(|E|) preprocessing that feeds HBM.
//
// Design: counting-sort adjacency build, OpenMP-parallel with per-thread
// histograms and atomic cursor placement (the lock-free write-cursor idea of
// the reference's emit_buffer path, network.cpp:511, applied to preprocessing
// instead of messaging). C ABI for ctypes; the Python side owns all memory
// (NumPy buffers), so there is no allocator coupling.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Degree counting: out_degree[src[e]]++, in_degree[dst[e]]++.
void nts_count_degrees(const uint32_t* src, const uint32_t* dst, int64_t e_num,
                       int32_t v_num, int32_t* out_degree, int32_t* in_degree) {
  std::memset(out_degree, 0, sizeof(int32_t) * v_num);
  std::memset(in_degree, 0, sizeof(int32_t) * v_num);
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < e_num; ++e) {
    __atomic_fetch_add(&out_degree[src[e]], 1, __ATOMIC_RELAXED);
    __atomic_fetch_add(&in_degree[dst[e]], 1, __ATOMIC_RELAXED);
  }
}

// Dual CSC/CSR build with per-edge weights, counting-sort placement.
// weight_mode: 0 = gcn_norm (1/sqrt(max(d_out(src),1)*max(d_in(dst),1)),
// ntsBaseOp.hpp:194), 1 = ones.
// column_offset/row_offset are [v_num+1] and must already hold the exclusive
// prefix sums of in_degree/out_degree (caller computes them — cheap).
void nts_build_adjacency(const uint32_t* src, const uint32_t* dst,
                         int64_t e_num, int32_t v_num, int weight_mode,
                         const int32_t* out_degree, const int32_t* in_degree,
                         const int64_t* column_offset, int32_t* csc_src,
                         int32_t* csc_dst, float* csc_w,
                         const int64_t* row_offset, int32_t* csr_src,
                         int32_t* csr_dst, float* csr_w) {
  std::atomic<int64_t>* csc_cursor = new std::atomic<int64_t>[v_num];
  std::atomic<int64_t>* csr_cursor = new std::atomic<int64_t>[v_num];
#pragma omp parallel for schedule(static)
  for (int32_t v = 0; v < v_num; ++v) {
    csc_cursor[v].store(column_offset[v], std::memory_order_relaxed);
    csr_cursor[v].store(row_offset[v], std::memory_order_relaxed);
  }
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < e_num; ++e) {
    const uint32_t s = src[e], d = dst[e];
    float w = 1.0f;
    if (weight_mode == 0) {
      const float ds = (float)(out_degree[s] > 0 ? out_degree[s] : 1);
      const float dd = (float)(in_degree[d] > 0 ? in_degree[d] : 1);
      w = 1.0f / std::sqrt(ds * dd);
    }
    const int64_t pc = csc_cursor[d].fetch_add(1, std::memory_order_relaxed);
    csc_src[pc] = (int32_t)s;
    csc_dst[pc] = (int32_t)d;
    csc_w[pc] = w;
    const int64_t pr = csr_cursor[s].fetch_add(1, std::memory_order_relaxed);
    csr_src[pr] = (int32_t)s;
    csr_dst[pr] = (int32_t)d;
    csr_w[pr] = w;
  }
  delete[] csc_cursor;
  delete[] csr_cursor;
}

// xorshift64* PRNG — deterministic per (seed, dst) stream.
static inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

// Fan-out neighbor sampling over a CSC adjacency: for each of n_dst
// destinations, uniformly choose min(deg, fanout) distinct in-neighbors
// (reservoir algorithm — the reference's ntsSampler.hpp:138-158 loop).
// Outputs are preallocated [n_dst * fanout]; returns edges written per dst
// in out_counts. out_src holds global source ids, out_dst_idx the dst's
// index in the input list.
void nts_sample_hop(const int64_t* column_offset, const int32_t* row_indices,
                    const int64_t* dsts, int64_t n_dst, int32_t fanout,
                    uint64_t seed, int32_t* out_src, int32_t* out_dst_idx,
                    int32_t* out_counts) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n_dst; ++i) {
    const int64_t v = dsts[i];
    const int64_t lo = column_offset[v], hi = column_offset[v + 1];
    const int64_t deg = hi - lo;
    int32_t* dst_out = out_src + i * fanout;
    int64_t rs = seed * 0x9E3779B97F4A7C15ULL + (uint64_t)v + 1;
    int64_t k = 0;
    if (deg <= fanout) {
      for (int64_t j = lo; j < hi; ++j) dst_out[k++] = row_indices[j];
    } else if (deg > (int64_t)fanout * 8 && fanout <= 256) {
      // Floyd's distinct sampling: O(fanout) uniform positions. The
      // reservoir below is O(deg) per destination — on a power-law graph
      // a 2^21-degree hub drawn as a dst costs a 2M-edge scan every batch
      // (measured 70 of 94 ms/batch at full Reddit scale); Floyd never
      // touches the adjacency beyond the sampled slots.
      int64_t pos[256];
      for (int64_t j = deg - fanout; j < deg; ++j) {
        int64_t t = (int64_t)(xorshift64((uint64_t*)&rs) % (uint64_t)(j + 1));
        int found = 0;
        for (int64_t m = 0; m < k; ++m)
          if (pos[m] == t) { found = 1; break; }
        pos[k++] = found ? j : t;
      }
      for (int64_t m = 0; m < k; ++m)
        dst_out[m] = row_indices[lo + pos[m]];
    } else {
      // reservoir: fill first `fanout`, then replace with prob fanout/j
      for (int64_t j = 0; j < fanout; ++j) dst_out[j] = row_indices[lo + j];
      k = fanout;
      for (int64_t j = fanout; j < deg; ++j) {
        const uint64_t r = xorshift64((uint64_t*)&rs) % (uint64_t)(j + 1);
        if ((int64_t)r < fanout) dst_out[r] = row_indices[lo + j];
      }
    }
    out_counts[i] = (int32_t)k;
    for (int64_t j = 0; j < k; ++j) out_dst_idx[i * fanout + j] = (int32_t)i;
  }
}

// Sorted dedup + remap of a batch's sampled source ids (the hot part of
// sampCSC::postprocessing, coocsc.hpp:62-89 — std::map there). Two hash
// passes around one m-element sort beat numpy's full n log n sort+search:
// (1) open-addressing insert of all n ids -> unique set, (2) sort the m
// uniques (sorted ids keep the device feature-gather local), (3) re-insert
// sorted ids, (4) look up each id's local index. Returns m. uniq must have
// capacity >= n; local capacity n.
static inline int64_t nts_hash_slot(int64_t key, int64_t mask) {
  uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ULL;
  return (int64_t)((h ^ (h >> 29)) & (uint64_t)mask);
}

int64_t nts_dedup_remap(const int64_t* ids, int64_t n, int64_t* uniq,
                        int32_t* local) {
  if (n == 0) return 0;
  int64_t cap = 1;
  while (cap < n * 2) cap <<= 1;
  const int64_t mask = cap - 1;
  int64_t* keys = new int64_t[cap];
  int32_t* vals = new int32_t[cap];
  for (int64_t i = 0; i < cap; ++i) keys[i] = -1;
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = ids[i];
    int64_t s = nts_hash_slot(k, mask);
    while (keys[s] != -1 && keys[s] != k) s = (s + 1) & mask;
    if (keys[s] == -1) {
      keys[s] = k;
      uniq[m++] = k;
    }
  }
  // insertion sort is fine for tiny m; std::sort otherwise
  std::sort(uniq, uniq + m);
  for (int64_t i = 0; i < cap; ++i) keys[i] = -1;
  for (int64_t j = 0; j < m; ++j) {
    int64_t s = nts_hash_slot(uniq[j], mask);
    while (keys[s] != -1) s = (s + 1) & mask;
    keys[s] = uniq[j];
    vals[s] = (int32_t)j;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = ids[i];
    int64_t s = nts_hash_slot(k, mask);
    while (keys[s] != k) s = (s + 1) & mask;
    local[i] = vals[s];
  }
  delete[] keys;
  delete[] vals;
  return m;
}

// Stable counting sort of edges by source tile. Input edges are already
// dst-grouped (CSC order), so the output permutation is (tile, dst)-sorted —
// the order the blocked ELL layout needs (ops/blocked_ell.py) without the
// O(E log E) comparison sort. Single pass each for histogram and placement.
void nts_sort_by_tile(const int32_t* tile, int64_t e_num, int32_t n_tiles,
                      int64_t* order) {
  int64_t* cursor = new int64_t[n_tiles + 1]();
  for (int64_t e = 0; e < e_num; ++e) ++cursor[tile[e] + 1];
  for (int32_t t = 0; t < n_tiles; ++t) cursor[t + 1] += cursor[t];
  for (int64_t e = 0; e < e_num; ++e) order[cursor[tile[e]]++] = e;
  delete[] cursor;
}

// Fill one stacked blocked-ELL level: row r's run of `row_len[r]` sorted
// edges is copied into nbr/wgt[row_tile[r], row_slot[r], :] and its dst
// recorded. Caller zero-inits nbr/wgt and v_num-fills dstr (padding rows).
void nts_fill_blocked_level(const int64_t* row_start, const int64_t* row_len,
                            const int32_t* row_tile, const int32_t* row_dst,
                            const int64_t* row_slot, int64_t n_rows,
                            int64_t n_l, int32_t K,
                            const int32_t* src_sorted, const float* w_sorted,
                            int32_t* nbr, float* wgt, int32_t* dstr) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t base = (int64_t)row_tile[r] * n_l + row_slot[r];
    int32_t* nb = nbr + base * K;
    float* wg = wgt + base * K;
    const int64_t lo = row_start[r];
    const int64_t len = row_len[r];
    for (int64_t j = 0; j < len; ++j) {
      nb[j] = src_sorted[lo + j];
      wg[j] = w_sorted[lo + j];
    }
    dstr[base] = row_dst[r];
  }
}

// Fill the block-sparse packed tables (ops/bsp_ell.py): run u (one
// destination's in-edge run within one source-tile group, already sorted)
// spans rows row_of_first[u] .. +ceil(len/K); edge j of the run lands in
// block row_block[row], lane row_slot[row], slot j%K. Caller zero-inits
// nbr/wgt and zero-inits ldst. One OpenMP pass over runs replaces the
// three O(E) fancy-index scatters of the NumPy build (its measured
// bottleneck at full scale).
void nts_fill_bsp(const int64_t* run_start, const int64_t* run_len,
                  const int64_t* row_of_first, const int32_t* run_ldst,
                  int64_t n_runs, const int64_t* row_block,
                  const int64_t* row_slot, const int32_t* src_local,
                  const float* w_sorted, int32_t K, int32_t R,
                  int32_t* nbr, float* wgt, int32_t* ldst) {
#pragma omp parallel for schedule(static)
  for (int64_t u = 0; u < n_runs; ++u) {
    const int64_t lo = run_start[u];
    const int64_t len = run_len[u];
    const int64_t row0 = row_of_first[u];
    const int32_t d = run_ldst[u];
    for (int64_t j = 0; j < len; ++j) {
      const int64_t row = row0 + j / K;
      const int64_t b = row_block[row];
      const int64_t s = row_slot[row];
      const int64_t at = (b * K + (j % K)) * R + s;
      nbr[at] = src_local[lo + j];
      wgt[at] = w_sorted[lo + j];
      if (j % K == 0) ldst[b * R + s] = d;
    }
  }
}

int nts_native_version(void) { return 6; }

}  // extern "C"
