// Native spatial graph partitioner (C++/OpenMP).
//
// The PyTorch port's copy of distmlip_tpu/neighbors/src/partition.cpp: the
// host fast path mirroring distmlip_tpu_torch/partition/partitioner.py (the
// numpy oracle) exactly — same slab rule inputs (walls computed host-side in
// Python), same [pure | to_* | from_*] section layout with ascending global
// ids, same owner-computes edge assignment, same directed line-graph
// construction and ordering. Behavioral ancestor: the reference's
// subgraph_creation_utils.c (see SURVEY.md §2.1 N2); this is a new
// implementation against the numpy spec, not a port.
//
// Memory notes: global->local maps use two slots per node (owner partition +
// halo target partition) instead of P x N arrays, so 1M-atom systems stay
// cheap at any partition count.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "thread_count.h"

namespace {

struct PartResult {
  int64_t P = 0;
  int err = 0;               // 0 ok; -2 multi-destination border node
  int64_t err_node = -1;
  bool has_bond = false;
  std::vector<std::vector<int64_t>> global_ids, node_markers;
  std::vector<std::vector<int64_t>> edge_ids, src_local, dst_local;
  std::vector<std::vector<int64_t>> bond_markers, bond_global_edge;
  std::vector<std::vector<int64_t>> line_src, line_dst, line_center;
  std::vector<std::vector<int64_t>> bm_edge, bm_bond;
};

}  // namespace

extern "C" {

void* dm_partition_build(
    int64_t n, int64_t ne, const int64_t* src, const int64_t* dst,
    const double* frac_axis,   // (n,) wrapped fractional coord along slab axis
    const double* walls,       // (P-1,) ascending
    int64_t P, const uint8_t* bond_mask, int use_bond_graph, int nthreads) {
  ThreadCountScope thread_count(nthreads);
  const bool threads = n >= kMinAtomsForThreads;
  auto* R = new PartResult();
  R->P = P;

  // --- node -> slab ---
  std::vector<int64_t> part(n);
#pragma omp parallel for schedule(static) if (threads)
  for (int64_t i = 0; i < n; ++i) {
    part[i] = std::upper_bound(walls, walls + (P - 1), frac_axis[i]) - walls;
  }

  // --- border classification (nodes_to_partition) ---
  std::vector<int64_t> ntp(n, -1);
  int err = 0;
  int64_t err_node = -1;
#pragma omp parallel for schedule(static) if (threads)
  for (int64_t e = 0; e < ne; ++e) {
    int64_t s = src[e], d = dst[e];
    int64_t ps = part[s], pd = part[d];
    if (ps == pd) continue;
    int64_t expected = -1;
    if (!__atomic_compare_exchange_n(&ntp[s], &expected, pd, false,
                                     __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
      if (expected != pd) {
#pragma omp critical
        {
          err = -2;
          err_node = s;
        }
      }
    }
  }
  if (err != 0) {
    R->err = err;
    R->err_node = err_node;
    return R;
  }

  // --- node sections: [pure | to_0..to_{P-1} | from_0..from_{P-1}] ---
  // counts[p][section]; section: 0 = pure, 1+q = to_q, 1+P+q = from_q
  const int64_t S = 1 + 2 * P;
  std::vector<std::vector<int64_t>> counts((size_t)P, std::vector<int64_t>(S, 0));
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = part[i];
    if (ntp[i] < 0) {
      counts[p][0]++;
    } else {
      counts[p][1 + ntp[i]]++;
      counts[ntp[i]][1 + P + p]++;
    }
  }
  R->global_ids.resize(P);
  R->node_markers.resize(P);
  std::vector<std::vector<int64_t>> sec_off((size_t)P, std::vector<int64_t>(S + 1, 0));
  for (int64_t p = 0; p < P; ++p) {
    for (int64_t s = 0; s < S; ++s) sec_off[p][s + 1] = sec_off[p][s] + counts[p][s];
    R->node_markers[p].assign(sec_off[p].begin(), sec_off[p].end());
    R->global_ids[p].resize(sec_off[p][S]);
  }
  // fill ascending-global-id within each section; record local ids:
  // two slots per node: local id in owner partition, local id in halo target
  std::vector<int64_t> loc_owner(n), loc_halo(n, -1);
  {
    std::vector<std::vector<int64_t>> cur = sec_off;  // running cursors
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = part[i];
      int64_t s = (ntp[i] < 0) ? 0 : 1 + ntp[i];
      int64_t li = cur[p][s]++;
      R->global_ids[p][li] = i;
      loc_owner[i] = li;
      if (ntp[i] >= 0) {
        int64_t q = ntp[i];
        int64_t lh = cur[q][1 + P + p]++;
        R->global_ids[q][lh] = i;
        loc_halo[i] = lh;
      }
    }
  }
  auto g2l = [&](int64_t p, int64_t node) -> int64_t {
    if (part[node] == p) return loc_owner[node];
    if (ntp[node] == p) return loc_halo[node];
    return -1;
  };

  // --- owner-computes edge assignment ---
  R->edge_ids.resize(P);
  R->src_local.resize(P);
  R->dst_local.resize(P);
  std::vector<int64_t> ecount(P, 0);
  for (int64_t e = 0; e < ne; ++e) ecount[part[dst[e]]]++;
  for (int64_t p = 0; p < P; ++p) {
    R->edge_ids[p].reserve(ecount[p]);
    R->src_local[p].resize(ecount[p]);
    R->dst_local[p].resize(ecount[p]);
  }
  std::vector<int64_t> edge_local(ne);
  for (int64_t e = 0; e < ne; ++e) {
    int64_t p = part[dst[e]];
    edge_local[e] = (int64_t)R->edge_ids[p].size();
    R->edge_ids[p].push_back(e);
  }
#pragma omp parallel for schedule(static) if (threads)
  for (int64_t e = 0; e < ne; ++e) {
    int64_t p = part[dst[e]];
    int64_t li = edge_local[e];
    R->src_local[p][li] = g2l(p, src[e]);
    R->dst_local[p][li] = g2l(p, dst[e]);
  }

  if (!use_bond_graph) return R;
  R->has_bond = true;

  // --- bond-graph nodes: within-bond edges W, sectioned like nodes ---
  std::vector<int64_t> W;
  W.reserve(ne / 4 + 1);
  for (int64_t e = 0; e < ne; ++e)
    if (bond_mask[e]) W.push_back(e);
  const int64_t nw = (int64_t)W.size();

  R->bond_markers.resize(P);
  R->bond_global_edge.resize(P);
  R->bm_edge.resize(P);
  R->bm_bond.resize(P);
  R->line_src.resize(P);
  R->line_dst.resize(P);
  R->line_center.resize(P);

  for (int64_t p = 0; p < P; ++p) {
    std::vector<int64_t> bc(S, 0);
    for (int64_t wi = 0; wi < nw; ++wi) {
      int64_t d = dst[W[wi]];
      if (part[d] == p) {
        bc[(ntp[d] < 0) ? 0 : 1 + ntp[d]]++;
      } else if (ntp[d] == p) {
        bc[1 + P + part[d]]++;
      }
    }
    std::vector<int64_t> off(S + 1, 0);
    for (int64_t s = 0; s < S; ++s) off[s + 1] = off[s] + bc[s];
    R->bond_markers[p].assign(off.begin(), off.end());
    R->bond_global_edge[p].resize(off[S]);
    std::vector<int64_t> cur = off;
    const int64_t owned_b = R->bond_markers[p][1 + P];
    R->bm_edge[p].resize(owned_b);
    R->bm_bond[p].resize(owned_b);
    for (int64_t wi = 0; wi < nw; ++wi) {
      int64_t e = W[wi];
      int64_t d = dst[e];
      if (part[d] == p) {
        int64_t s = (ntp[d] < 0) ? 0 : 1 + ntp[d];
        R->bond_global_edge[p][cur[s]++] = e;
      } else if (ntp[d] == p) {
        R->bond_global_edge[p][cur[1 + P + part[d]]++] = e;
      }
    }
    for (int64_t li = 0; li < owned_b; ++li) {
      R->bm_edge[p][li] = edge_local[R->bond_global_edge[p][li]];
      R->bm_bond[p][li] = li;
    }

    // --- line graph: a=(s->d), b=(d->k) with b locally computed, k != s ---
    const int64_t nb = (int64_t)R->bond_global_edge[p].size();
    // locally-computed bond nodes (local id < owned_b) grouped by global
    // src node, stable in local-id order
    std::vector<std::pair<int64_t, int64_t>> nil_by_src((size_t)owned_b);
    for (int64_t li = 0; li < owned_b; ++li)
      nil_by_src[li] = {src[R->bond_global_edge[p][li]], li};
    std::stable_sort(
        nil_by_src.begin(), nil_by_src.end(),
        [](const std::pair<int64_t, int64_t>& a,
           const std::pair<int64_t, int64_t>& b) { return a.first < b.first; });
    auto lower = [&](int64_t key) {
      return std::lower_bound(
          nil_by_src.begin(), nil_by_src.end(), key,
          [](const std::pair<int64_t, int64_t>& pr, int64_t k) {
            return pr.first < k;
          });
    };
    auto upper = [&](int64_t key) {
      return std::upper_bound(
          nil_by_src.begin(), nil_by_src.end(), key,
          [](int64_t k, const std::pair<int64_t, int64_t>& pr) {
            return k < pr.first;
          });
    };
    std::vector<int64_t> lcount(nb, 0);
#pragma omp parallel for schedule(dynamic, 256) if (threads)
    for (int64_t a = 0; a < nb; ++a) {
      int64_t e_a = R->bond_global_edge[p][a];
      int64_t gs = src[e_a], gd = dst[e_a];
      int64_t c = 0;
      for (auto it = lower(gd); it != upper(gd); ++it) {
        if (dst[R->bond_global_edge[p][it->second]] != gs) ++c;
      }
      lcount[a] = c;
    }
    std::vector<int64_t> loff(nb + 1, 0);
    for (int64_t a = 0; a < nb; ++a) loff[a + 1] = loff[a] + lcount[a];
    R->line_src[p].resize(loff[nb]);
    R->line_dst[p].resize(loff[nb]);
    R->line_center[p].resize(loff[nb]);
#pragma omp parallel for schedule(dynamic, 256) if (threads)
    for (int64_t a = 0; a < nb; ++a) {
      int64_t e_a = R->bond_global_edge[p][a];
      int64_t gs = src[e_a], gd = dst[e_a];
      int64_t w = loff[a];
      for (auto it = lower(gd); it != upper(gd); ++it) {
        int64_t b = it->second;
        int64_t e_b = R->bond_global_edge[p][b];
        if (dst[e_b] == gs) continue;
        R->line_src[p][w] = a;
        R->line_dst[p][w] = b;
        R->line_center[p][w] = g2l(p, src[e_b]);
        ++w;
      }
    }
  }
  return R;
}

int dm_partition_err(void* h, int64_t* err_node) {
  auto* R = static_cast<PartResult*>(h);
  *err_node = R->err_node;
  return R->err;
}

// sizes for partition p: [n_nodes, n_edges, n_bonds, n_lines, n_bm]
void dm_partition_sizes(void* h, int64_t p, int64_t* out) {
  auto* R = static_cast<PartResult*>(h);
  out[0] = (int64_t)R->global_ids[p].size();
  out[1] = (int64_t)R->edge_ids[p].size();
  out[2] = R->has_bond ? (int64_t)R->bond_global_edge[p].size() : 0;
  out[3] = R->has_bond ? (int64_t)R->line_src[p].size() : 0;
  out[4] = R->has_bond ? (int64_t)R->bm_edge[p].size() : 0;
}

void dm_partition_copy(void* h, int64_t p, int64_t* global_ids,
                       int64_t* node_markers, int64_t* edge_ids,
                       int64_t* src_local, int64_t* dst_local,
                       int64_t* bond_markers, int64_t* bond_global_edge,
                       int64_t* line_src, int64_t* line_dst,
                       int64_t* line_center, int64_t* bm_edge,
                       int64_t* bm_bond) {
  auto* R = static_cast<PartResult*>(h);
  auto cp = [](int64_t* out, const std::vector<int64_t>& v) {
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
  };
  cp(global_ids, R->global_ids[p]);
  cp(node_markers, R->node_markers[p]);
  cp(edge_ids, R->edge_ids[p]);
  cp(src_local, R->src_local[p]);
  cp(dst_local, R->dst_local[p]);
  if (R->has_bond) {
    cp(bond_markers, R->bond_markers[p]);
    cp(bond_global_edge, R->bond_global_edge[p]);
    cp(line_src, R->line_src[p]);
    cp(line_dst, R->line_dst[p]);
    cp(line_center, R->line_center[p]);
    cp(bm_edge, R->bm_edge[p]);
    cp(bm_bond, R->bm_bond[p]);
  }
}

void dm_partition_free(void* h) { delete static_cast<PartResult*>(h); }

}  // extern "C"
