// Native graph-preprocessing runtime for neuralgraphpde.
//
// The compute path is JAX/XLA; this library is the host-side runtime around
// it (SURVEY §2.2 native-code plan): edge sorting, CSR construction, edge
// partitioning and spatial graph building at C++ speed for
// multi-million-edge meshes, exposed through a
// C ABI consumed via ctypes (neuralgraphpde/native.py).
//
// All functions are single-threaded O(E)-ish passes; callers parallelize
// across graphs/shards.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <algorithm>

extern "C" {

// Stable counting sort of edges by receiver. perm_out[k] = original index of
// the k-th edge in receiver-sorted order. Returns 0 on success.
int ngp_sort_by_receiver(int64_t num_edges, int64_t num_nodes,
                         const int32_t* receivers, int64_t* perm_out) {
  std::vector<int64_t> counts(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    int32_t r = receivers[e];
    if (r < 0 || r >= num_nodes) return 1;
    counts[r + 1]++;
  }
  for (int64_t i = 0; i < num_nodes; ++i) counts[i + 1] += counts[i];
  for (int64_t e = 0; e < num_edges; ++e) {
    perm_out[counts[receivers[e]]++] = e;
  }
  return 0;
}

// CSR row offsets (num_nodes + 1) from receiver-sorted receivers.
int ngp_csr_offsets(int64_t num_edges, int64_t num_nodes,
                    const int32_t* sorted_receivers, int64_t* offsets_out) {
  std::vector<int64_t> counts(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    int32_t r = sorted_receivers[e];
    if (r < 0 || r >= num_nodes) return 1;
    counts[r]++;
  }
  offsets_out[0] = 0;
  for (int64_t i = 0; i < num_nodes; ++i)
    offsets_out[i + 1] = offsets_out[i] + counts[i];
  return 0;
}

// Greedy balanced edge partitioner: assigns each receiver-node's edge block
// to the currently lightest partition, receivers visited in decreasing
// degree order. part_of_node_out: (num_nodes) int32.
int ngp_greedy_partition(int64_t num_edges, int64_t num_nodes,
                         const int32_t* receivers, int64_t num_parts,
                         int32_t* part_of_node_out) {
  std::vector<int64_t> degree(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) degree[receivers[e]]++;
  std::vector<int64_t> order(num_nodes);
  for (int64_t i = 0; i < num_nodes; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return degree[a] > degree[b];
  });
  std::vector<int64_t> load(num_parts, 0);
  for (int64_t idx = 0; idx < num_nodes; ++idx) {
    int64_t node = order[idx];
    int64_t best = 0;
    for (int64_t p = 1; p < num_parts; ++p)
      if (load[p] < load[best]) best = p;
    part_of_node_out[node] = static_cast<int32_t>(best);
    load[best] += degree[node] + 1;  // +1 balances node counts too
  }
  return 0;
}

// 2D radius graph via cell lists. Phase 1: count edges (excluding self).
int64_t ngp_radius_graph_2d_count(int64_t n, const float* xy, float radius) {
  float cell = radius;
  float minx = 1e30f, miny = 1e30f, maxx = -1e30f, maxy = -1e30f;
  for (int64_t i = 0; i < n; ++i) {
    minx = std::min(minx, xy[2 * i]);
    maxx = std::max(maxx, xy[2 * i]);
    miny = std::min(miny, xy[2 * i + 1]);
    maxy = std::max(maxy, xy[2 * i + 1]);
  }
  int64_t gx = std::max<int64_t>(1, (int64_t)((maxx - minx) / cell) + 1);
  int64_t gy = std::max<int64_t>(1, (int64_t)((maxy - miny) / cell) + 1);
  std::vector<std::vector<int32_t>> cells(gx * gy);
  auto cell_of = [&](int64_t i) {
    int64_t cx = std::min<int64_t>(gx - 1, (int64_t)((xy[2 * i] - minx) / cell));
    int64_t cy = std::min<int64_t>(gy - 1, (int64_t)((xy[2 * i + 1] - miny) / cell));
    return cx * gy + cy;
  };
  for (int64_t i = 0; i < n; ++i) cells[cell_of(i)].push_back((int32_t)i);
  float r2 = radius * radius;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = std::min<int64_t>(gx - 1, (int64_t)((xy[2 * i] - minx) / cell));
    int64_t cy = std::min<int64_t>(gy - 1, (int64_t)((xy[2 * i + 1] - miny) / cell));
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy) {
        int64_t nx = cx + dx, ny = cy + dy;
        if (nx < 0 || nx >= gx || ny < 0 || ny >= gy) continue;
        for (int32_t j : cells[nx * gy + ny]) {
          if (j == i) continue;
          float ddx = xy[2 * i] - xy[2 * j];
          float ddy = xy[2 * i + 1] - xy[2 * j + 1];
          if (ddx * ddx + ddy * ddy <= r2) ++count;
        }
      }
  }
  return count;
}

// Phase 2: fill senders/receivers (edge j -> i for each neighbor j of i).
int ngp_radius_graph_2d_build(int64_t n, const float* xy, float radius,
                              int32_t* senders_out, int32_t* receivers_out) {
  float cell = radius;
  float minx = 1e30f, miny = 1e30f, maxx = -1e30f, maxy = -1e30f;
  for (int64_t i = 0; i < n; ++i) {
    minx = std::min(minx, xy[2 * i]);
    maxx = std::max(maxx, xy[2 * i]);
    miny = std::min(miny, xy[2 * i + 1]);
    maxy = std::max(maxy, xy[2 * i + 1]);
  }
  int64_t gx = std::max<int64_t>(1, (int64_t)((maxx - minx) / cell) + 1);
  int64_t gy = std::max<int64_t>(1, (int64_t)((maxy - miny) / cell) + 1);
  std::vector<std::vector<int32_t>> cells(gx * gy);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = std::min<int64_t>(gx - 1, (int64_t)((xy[2 * i] - minx) / cell));
    int64_t cy = std::min<int64_t>(gy - 1, (int64_t)((xy[2 * i + 1] - miny) / cell));
    cells[cx * gy + cy].push_back((int32_t)i);
  }
  float r2 = radius * radius;
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = std::min<int64_t>(gx - 1, (int64_t)((xy[2 * i] - minx) / cell));
    int64_t cy = std::min<int64_t>(gy - 1, (int64_t)((xy[2 * i + 1] - miny) / cell));
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy) {
        int64_t nx = cx + dx, ny = cy + dy;
        if (nx < 0 || nx >= gx || ny < 0 || ny >= gy) continue;
        for (int32_t j : cells[nx * gy + ny]) {
          if (j == i) continue;
          float ddx = xy[2 * i] - xy[2 * j];
          float ddy = xy[2 * i + 1] - xy[2 * j + 1];
          if (ddx * ddx + ddy * ddy <= r2) {
            senders_out[k] = j;
            receivers_out[k] = (int32_t)i;
            ++k;
          }
        }
      }
  }
  return 0;
}

}  // extern "C"
