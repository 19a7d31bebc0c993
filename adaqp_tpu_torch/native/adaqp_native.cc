// Native host-side graph preprocessing of adaqp_tpu_torch (C ABI, loaded
// with ctypes by native/__init__.py beside this file).
//
// The upstream system delegated partitioning to DGL/METIS C++
// (dgl.distributed.partition_graph, AdaQP/helper/partition.py:69-72). This
// library does the host-side steps that are Python-loop-bound at
// 100M-edge scale: CSR construction, BFS ordering and LDG streaming
// partitioning, the same algorithm as graph/partition.py's numpy path,
// which it must match partition for partition.
//
// Build (native/__init__.py does this on first use, into build/native/):
//   g++ -O3 -march=native -shared -fPIC adaqp_native.cc -o libadaqp_native.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>
#include <algorithm>

extern "C" {

// Counting-sort CSR build: edges (src[i] -> dst[i]) grouped by src.
// out_indptr: int64[n+1], out_indices: int32[e] (dst per src run).
void build_csr(int64_t n, int64_t e, const int32_t* src, const int32_t* dst,
               int64_t* out_indptr, int32_t* out_indices) {
  std::memset(out_indptr, 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) out_indptr[src[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) out_indptr[v + 1] += out_indptr[v];
  std::vector<int64_t> cursor(out_indptr, out_indptr + n);
  for (int64_t i = 0; i < e; ++i) out_indices[cursor[src[i]]++] = dst[i];
}

// BFS order from max-degree seeds, restarting per component.
// out_order: int64[n].
void bfs_order(int64_t n, const int64_t* indptr, const int32_t* indices,
               int64_t* out_order) {
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> seeds(n);
  for (int64_t v = 0; v < n; ++v) seeds[v] = v;
  std::sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
    return (indptr[a + 1] - indptr[a]) > (indptr[b + 1] - indptr[b]);
  });
  int64_t pos = 0;
  std::queue<int64_t> q;
  for (int64_t s : seeds) {
    if (visited[s]) continue;
    visited[s] = 1;
    q.push(s);
    while (!q.empty()) {
      int64_t v = q.front();
      q.pop();
      out_order[pos++] = v;
      for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
        int32_t u = indices[j];
        if (!visited[u]) {
          visited[u] = 1;
          q.push(u);
        }
      }
    }
  }
}

// Linear Deterministic Greedy streaming partitioning in the given order.
// part: int32[n] output; scores scratch internal.
void ldg_partition(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const int64_t* order, int32_t k, double slack,
                   int32_t* out_part) {
  const double cap = slack * static_cast<double>(n) / k;
  std::vector<int64_t> sizes(k, 0);
  std::vector<double> counts(k);
  std::fill_n(out_part, n, -1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = order[i];
    std::fill(counts.begin(), counts.end(), 0.0);
    for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
      int32_t p = out_part[indices[j]];
      if (p >= 0) counts[p] += 1.0;
    }
    int32_t best = 0;
    double best_score = -1.0;
    for (int32_t p = 0; p < k; ++p) {
      double score = counts[p] * (1.0 - sizes[p] / cap);
      if (score > best_score ||
          (score == best_score && sizes[p] < sizes[best])) {
        best_score = score;
        best = p;
      }
    }
    out_part[v] = best;
    sizes[best]++;
  }
}

}  // extern "C"
