// One order for the native CSC/CSR build, whatever the thread timing.
//
// nts_build_adjacency (graph_native.cpp, JAX's source kept code-equal)
// places a vertex's edges through atomic cursors, so their order within the
// vertex's segment, and the order of a sum over them, changes from build to
// build. Sorting each segment by neighbour id makes every build of one edge
// list the same arrays in every process. Edges that tie on the neighbour
// join the same two vertices, so they carry the same weight (gcn_norm and
// ones are functions of the two degrees).
#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// Sort each segment [offset[v], offset[v+1]) of (nbr, w) by nbr, in place.
void nts_sort_segments(const int64_t* offset, int32_t v_num, int32_t* nbr,
                       float* w) {
#pragma omp parallel
  {
    std::vector<std::pair<int32_t, float>> buf;
#pragma omp for schedule(dynamic, 256)
    for (int32_t v = 0; v < v_num; ++v) {
      const int64_t lo = offset[v], hi = offset[v + 1];
      if (hi - lo < 2) continue;
      buf.resize(hi - lo);
      for (int64_t j = lo; j < hi; ++j) buf[j - lo] = {nbr[j], w[j]};
      std::sort(buf.begin(), buf.end(),
                [](const std::pair<int32_t, float>& a,
                   const std::pair<int32_t, float>& b) { return a.first < b.first; });
      for (int64_t j = lo; j < hi; ++j) {
        nbr[j] = buf[j - lo].first;
        w[j] = buf[j - lo].second;
      }
    }
  }
}

}  // extern "C"
