// Native periodic neighbor search (linked-cell, OpenMP).
//
// Host-side equivalent of the reference's FPIS layer (behavioral spec at
// reference fpis.c:418-856; this is a new implementation, not a port).
// The PyTorch port's copy of distmlip_tpu/neighbors/src/neighbor.cpp:
//   * dual cutoff in one pass (atom cutoff r, bond cutoff bond_r <= r)
//   * image offsets relative to the unwrapped input coordinates
//   * self pairs (d < 1e-8) excluded; periodic self-images kept
//   * two-pass count -> prefix-sum -> fill parallelism (race-free)
//
// Exposed through a C ABI consumed via ctypes (neighbors/native.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "thread_count.h"

namespace {

constexpr double kNumericalTol = 1e-8;

struct Mat3 {
  double m[9];  // row-major; rows are lattice vectors
};

static Mat3 invert3(const Mat3& a) {
  const double* p = a.m;
  double det = p[0] * (p[4] * p[8] - p[5] * p[7]) -
               p[1] * (p[3] * p[8] - p[5] * p[6]) +
               p[2] * (p[3] * p[7] - p[4] * p[6]);
  double id = 1.0 / det;
  Mat3 r;
  r.m[0] = (p[4] * p[8] - p[5] * p[7]) * id;
  r.m[1] = (p[2] * p[7] - p[1] * p[8]) * id;
  r.m[2] = (p[1] * p[5] - p[2] * p[4]) * id;
  r.m[3] = (p[5] * p[6] - p[3] * p[8]) * id;
  r.m[4] = (p[0] * p[8] - p[2] * p[6]) * id;
  r.m[5] = (p[2] * p[3] - p[0] * p[5]) * id;
  r.m[6] = (p[3] * p[7] - p[4] * p[6]) * id;
  r.m[7] = (p[1] * p[6] - p[0] * p[7]) * id;
  r.m[8] = (p[0] * p[4] - p[1] * p[3]) * id;
  return r;
}

// frac = cart @ inv(lattice)
static inline void cart_to_frac(const double* cart, const Mat3& inv, double* frac) {
  for (int k = 0; k < 3; ++k)
    frac[k] = cart[0] * inv.m[0 + k] + cart[1] * inv.m[3 + k] + cart[2] * inv.m[6 + k];
}

static inline void frac_to_cart(const double* frac, const Mat3& lat, double* cart) {
  for (int k = 0; k < 3; ++k)
    cart[k] = frac[0] * lat.m[0 + k] + frac[1] * lat.m[3 + k] + frac[2] * lat.m[6 + k];
}

struct NeighborResult {
  std::vector<int64_t> src, dst;
  std::vector<int32_t> offsets;    // 3*E
  std::vector<double> distances;   // E
  std::vector<uint8_t> bond_mask;  // E
  std::vector<double> wrapped;     // 3*N
  std::vector<int64_t> shift;      // 3*N
};

struct ExpandedPoint {
  double x, y, z;
  int64_t atom;
  int32_t ix, iy, iz;  // image offset
};

}  // namespace

extern "C" {

void* dm_neighbor_build(int64_t n, const double* cart, const double* lattice_in,
                        const int64_t* pbc, double r, double bond_r, double tol,
                        int nthreads) {
  if (n <= 0 || r <= 0) return nullptr;
  ThreadCountScope thread_count(nthreads);
  const bool threads = n >= kMinAtomsForThreads;
  Mat3 lat;
  std::memcpy(lat.m, lattice_in, sizeof(lat.m));
  Mat3 inv = invert3(lat);

  auto* res = new NeighborResult();
  res->wrapped.resize(3 * n);
  res->shift.resize(3 * n);
  std::vector<double> frac(3 * n);

  // wrap into [0,1) along periodic axes, remember the removed translations
#pragma omp parallel for schedule(static) if (threads)
  for (int64_t i = 0; i < n; ++i) {
    double f[3];
    cart_to_frac(cart + 3 * i, inv, f);
    for (int k = 0; k < 3; ++k) {
      int64_t s = 0;
      if (pbc[k]) {
        s = (int64_t)std::floor(f[k]);
        double w = f[k] - (double)s;
        if (w >= 1.0) { s += 1; w = f[k] - (double)s; }
        f[k] = w;
      }
      frac[3 * i + k] = f[k];
      res->shift[3 * i + k] = s;
    }
    frac_to_cart(f, lat, &res->wrapped[3 * i]);
  }

  // plane spacings -> image counts per axis; non-periodic axes are never
  // wrapped, so atoms may sit at any fractional coordinate there — no
  // margin culling on those axes
  double dspace[3], margin[3];
  int64_t nimg[3];
  for (int k = 0; k < 3; ++k) {
    double nk = std::sqrt(inv.m[0 + k] * inv.m[0 + k] + inv.m[3 + k] * inv.m[3 + k] +
                          inv.m[6 + k] * inv.m[6 + k]);
    dspace[k] = 1.0 / nk;
    margin[k] = pbc[k] ? r / dspace[k] + 1e-12 : 1e300;
    nimg[k] = pbc[k] ? (int64_t)std::floor(r / dspace[k]) + 1 : 0;
  }

  // --- expand periodic images within a margin of r around the cell (2-pass) ---
  int64_t n_off = (2 * nimg[0] + 1) * (2 * nimg[1] + 1) * (2 * nimg[2] + 1);
  std::vector<ExpandedPoint> pts;
  {
    std::vector<int64_t> counts(n_off, 0);
#pragma omp parallel for schedule(static) if (threads)
    for (int64_t o = 0; o < n_off; ++o) {
      int64_t t = o;
      int64_t oz = t % (2 * nimg[2] + 1) - nimg[2]; t /= (2 * nimg[2] + 1);
      int64_t oy = t % (2 * nimg[1] + 1) - nimg[1]; t /= (2 * nimg[1] + 1);
      int64_t ox = t - nimg[0];
      int64_t c = 0;
      for (int64_t i = 0; i < n; ++i) {
        double fx = frac[3 * i + 0] + ox, fy = frac[3 * i + 1] + oy, fz = frac[3 * i + 2] + oz;
        if (fx >= -margin[0] && fx <= 1 + margin[0] && fy >= -margin[1] &&
            fy <= 1 + margin[1] && fz >= -margin[2] && fz <= 1 + margin[2])
          ++c;
      }
      counts[o] = c;
    }
    std::vector<int64_t> offs(n_off + 1, 0);
    for (int64_t o = 0; o < n_off; ++o) offs[o + 1] = offs[o] + counts[o];
    pts.resize(offs[n_off]);
#pragma omp parallel for schedule(static) if (threads)
    for (int64_t o = 0; o < n_off; ++o) {
      int64_t t = o;
      int64_t oz = t % (2 * nimg[2] + 1) - nimg[2]; t /= (2 * nimg[2] + 1);
      int64_t oy = t % (2 * nimg[1] + 1) - nimg[1]; t /= (2 * nimg[1] + 1);
      int64_t ox = t - nimg[0];
      int64_t w = offs[o];
      for (int64_t i = 0; i < n; ++i) {
        double f[3] = {frac[3 * i + 0] + ox, frac[3 * i + 1] + oy, frac[3 * i + 2] + oz};
        if (f[0] < -margin[0] || f[0] > 1 + margin[0] || f[1] < -margin[1] ||
            f[1] > 1 + margin[1] || f[2] < -margin[2] || f[2] > 1 + margin[2])
          continue;
        double c[3];
        frac_to_cart(f, lat, c);
        pts[w++] = ExpandedPoint{c[0], c[1], c[2], i, (int32_t)ox, (int32_t)oy, (int32_t)oz};
      }
    }
  }
  const int64_t npts = (int64_t)pts.size();

  // --- linked cells over expanded points (counting sort) ---
  double edge = std::max(r, 0.1);
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (const auto& p : pts) {
    lo[0] = std::min(lo[0], p.x); hi[0] = std::max(hi[0], p.x);
    lo[1] = std::min(lo[1], p.y); hi[1] = std::max(hi[1], p.y);
    lo[2] = std::min(lo[2], p.z); hi[2] = std::max(hi[2], p.z);
  }
  for (int k = 0; k < 3; ++k) lo[k] -= 1e-9;
  int64_t nc[3];
  for (int k = 0; k < 3; ++k)
    nc[k] = std::max<int64_t>(1, (int64_t)std::floor((hi[k] - lo[k]) / edge) + 1);
  const int64_t ncell = nc[0] * nc[1] * nc[2];
  auto cell_of = [&](double x, double y, double z) -> int64_t {
    int64_t cx = (int64_t)((x - lo[0]) / edge);
    int64_t cy = (int64_t)((y - lo[1]) / edge);
    int64_t cz = (int64_t)((z - lo[2]) / edge);
    cx = std::min(std::max<int64_t>(cx, 0), nc[0] - 1);
    cy = std::min(std::max<int64_t>(cy, 0), nc[1] - 1);
    cz = std::min(std::max<int64_t>(cz, 0), nc[2] - 1);
    return (cx * nc[1] + cy) * nc[2] + cz;
  };
  std::vector<int64_t> cell_start(ncell + 1, 0), pt_cell(npts), pt_order(npts);
  for (int64_t p = 0; p < npts; ++p) {
    pt_cell[p] = cell_of(pts[p].x, pts[p].y, pts[p].z);
    cell_start[pt_cell[p] + 1]++;
  }
  for (int64_t c = 0; c < ncell; ++c) cell_start[c + 1] += cell_start[c];
  {
    std::vector<int64_t> cur(cell_start.begin(), cell_start.end() - 1);
    for (int64_t p = 0; p < npts; ++p) pt_order[cur[pt_cell[p]]++] = p;
  }

  // --- per-center 27-cell scan, 2-pass count/fill ---
  const double r_tol = r + tol;
  const double b_tol = bond_r > 0 ? bond_r + tol : -1.0;
  std::vector<int64_t> ecount(n, 0);
  auto scan = [&](int64_t i, bool fill, int64_t base) -> int64_t {
    const double* w = &res->wrapped[3 * i];
    int64_t cx = (int64_t)((w[0] - lo[0]) / edge);
    int64_t cy = (int64_t)((w[1] - lo[1]) / edge);
    int64_t cz = (int64_t)((w[2] - lo[2]) / edge);
    int64_t cnt = 0;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          int64_t x = cx + dx, y = cy + dy, z = cz + dz;
          if (x < 0 || x >= nc[0] || y < 0 || y >= nc[1] || z < 0 || z >= nc[2]) continue;
          int64_t c = (x * nc[1] + y) * nc[2] + z;
          for (int64_t s = cell_start[c]; s < cell_start[c + 1]; ++s) {
            const ExpandedPoint& p = pts[pt_order[s]];
            double ddx = p.x - w[0], ddy = p.y - w[1], ddz = p.z - w[2];
            double d = std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz);
            if (d >= r_tol || d <= kNumericalTol) continue;
            if (fill) {
              int64_t e = base + cnt;
              res->src[e] = i;
              res->dst[e] = p.atom;
              res->offsets[3 * e + 0] =
                  p.ix + (int32_t)(res->shift[3 * i + 0] - res->shift[3 * p.atom + 0]);
              res->offsets[3 * e + 1] =
                  p.iy + (int32_t)(res->shift[3 * i + 1] - res->shift[3 * p.atom + 1]);
              res->offsets[3 * e + 2] =
                  p.iz + (int32_t)(res->shift[3 * i + 2] - res->shift[3 * p.atom + 2]);
              res->distances[e] = d;
              res->bond_mask[e] = (b_tol > 0 && d < b_tol) ? 1 : 0;
            }
            ++cnt;
          }
        }
    return cnt;
  };

#pragma omp parallel for schedule(dynamic, 64) if (threads)
  for (int64_t i = 0; i < n; ++i) ecount[i] = scan(i, false, 0);
  std::vector<int64_t> estart(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) estart[i + 1] = estart[i] + ecount[i];
  const int64_t ne = estart[n];
  res->src.resize(ne);
  res->dst.resize(ne);
  res->offsets.resize(3 * ne);
  res->distances.resize(ne);
  res->bond_mask.resize(ne);
#pragma omp parallel for schedule(dynamic, 64) if (threads)
  for (int64_t i = 0; i < n; ++i) scan(i, true, estart[i]);

  return res;
}

int64_t dm_neighbor_num_edges(void* h) {
  return h ? (int64_t)static_cast<NeighborResult*>(h)->src.size() : -1;
}

void dm_neighbor_copy(void* h, int64_t* src, int64_t* dst, int32_t* offsets,
                      double* distances, uint8_t* bond_mask, double* wrapped,
                      int64_t* shift) {
  auto* r = static_cast<NeighborResult*>(h);
  std::memcpy(src, r->src.data(), r->src.size() * sizeof(int64_t));
  std::memcpy(dst, r->dst.data(), r->dst.size() * sizeof(int64_t));
  std::memcpy(offsets, r->offsets.data(), r->offsets.size() * sizeof(int32_t));
  std::memcpy(distances, r->distances.data(), r->distances.size() * sizeof(double));
  std::memcpy(bond_mask, r->bond_mask.data(), r->bond_mask.size() * sizeof(uint8_t));
  std::memcpy(wrapped, r->wrapped.data(), r->wrapped.size() * sizeof(double));
  std::memcpy(shift, r->shift.data(), r->shift.size() * sizeof(int64_t));
}

void dm_neighbor_free(void* h) { delete static_cast<NeighborResult*>(h); }

}  // extern "C"
