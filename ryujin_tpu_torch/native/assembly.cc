// Native offline assembly: isoparametric Q1 cG mass/c_ij matrices.
//
// C++ replacement for the hot path of ryujin_tpu_torch/offline/assembly.py
// (assemble(), cG Q1, no hanging nodes), the analog of the reference's
// WorkStream cell assembly (source/offline_data.template.h:
// 419-1105).  Same math: QGauss(2)^dim quadrature, deal.II vertex ordering
// (coordinate d toggles with stride 2^d), cell matrices
//   m_ij  = sum_q N_i N_j |J| w_q
//   c_ij  = sum_q N_i (J^{-T} dN_j) |J| w_q
// scattered into a per-row sorted CSR over master-mapped vertices.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// tensor-product Gauss(2) points on [0,1]
constexpr double GP0 = 0.21132486540518711775;  // (1 - 1/sqrt(3))/2
constexpr double GP1 = 0.78867513459481288225;

template <int DIM>
struct Q1 {
  static constexpr int NSH = 1 << DIM;
  static constexpr int NQ = 1 << DIM;  // QGauss(2)^dim
  double N[NQ][NSH];
  double dN[NQ][NSH][DIM];
  double w[NQ];

  Q1() {
    const double gp[2] = {GP0, GP1};
    for (int q = 0; q < NQ; ++q) {
      double pt[DIM];
      for (int d = 0; d < DIM; ++d) pt[d] = gp[(q >> d) & 1];
      w[q] = 1.0;
      for (int d = 0; d < DIM; ++d) w[q] *= 0.5;  // each 1D weight = 1/2
      for (int i = 0; i < NSH; ++i) {
        double n = 1.0;
        double dn[DIM];
        for (int d = 0; d < DIM; ++d) dn[d] = 1.0;
        for (int d = 0; d < DIM; ++d) {
          const int bit = (i >> d) & 1;
          const double xi = pt[d];
          const double f = bit ? xi : 1.0 - xi;
          const double df = bit ? 1.0 : -1.0;
          n *= f;
          for (int dd = 0; dd < DIM; ++dd) dn[dd] *= (dd == d) ? df : f;
        }
        N[q][i] = n;
        for (int d = 0; d < DIM; ++d) dN[q][i][d] = dn[d];
      }
    }
  }
};

template <int DIM>
void inv_det(const double J[DIM][DIM], double Jinv[DIM][DIM], double &det);

template <>
void inv_det<1>(const double J[1][1], double Jinv[1][1], double &det) {
  det = J[0][0];
  Jinv[0][0] = 1.0 / det;
}

template <>
void inv_det<2>(const double J[2][2], double Jinv[2][2], double &det) {
  det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  const double inv = 1.0 / det;
  Jinv[0][0] = J[1][1] * inv;
  Jinv[0][1] = -J[0][1] * inv;
  Jinv[1][0] = -J[1][0] * inv;
  Jinv[1][1] = J[0][0] * inv;
}

template <>
void inv_det<3>(const double J[3][3], double Jinv[3][3], double &det) {
  const double c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
  const double c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
  const double c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
  det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
  const double inv = 1.0 / det;
  Jinv[0][0] = c00 * inv;
  Jinv[1][0] = c01 * inv;
  Jinv[2][0] = c02 * inv;
  Jinv[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * inv;
  Jinv[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv;
  Jinv[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * inv;
  Jinv[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv;
  Jinv[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * inv;
  Jinv[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv;
}

// Build vertex -> adjacent-cells CSR.
void vertex_cells(int nsh, int64_t nc, int64_t nraw, const int64_t *acells,
                  std::vector<int64_t> &vptr, std::vector<int64_t> &vcell) {
  vptr.assign(nraw + 1, 0);
  for (int64_t e = 0; e < nc * nsh; ++e) vptr[acells[e] + 1]++;
  for (int64_t i = 0; i < nraw; ++i) vptr[i + 1] += vptr[i];
  vcell.resize(nc * nsh);
  std::vector<int64_t> cur(vptr.begin(), vptr.end() - 1);
  for (int64_t c = 0; c < nc; ++c)
    for (int s = 0; s < nsh; ++s) vcell[cur[acells[c * nsh + s]]++] = c;
}

// Collect the sorted unique off-diagonal neighbors of vertex i.
inline int row_neighbors(int nsh, const int64_t *acells,
                         const int64_t *vptr, const int64_t *vcell,
                         int64_t i, int64_t *buf, int cap) {
  int n = 0;
  for (int64_t p = vptr[i]; p < vptr[i + 1]; ++p) {
    const int64_t *cv = acells + vcell[p] * nsh;
    if (n + nsh > cap) return -1;  // pathological valence: caller bails
    for (int s = 0; s < nsh; ++s)
      if (cv[s] != i) buf[n++] = cv[s];
  }
  std::sort(buf, buf + n);
  return static_cast<int>(std::unique(buf, buf + n) - buf);
}

template <int DIM>
int64_t count_impl(int64_t nc, int64_t nraw, const int64_t *acells,
                   int64_t *indptr) {
  constexpr int NSH = 1 << DIM;
  std::vector<int64_t> vptr, vcell;
  vertex_cells(NSH, nc, nraw, acells, vptr, vcell);
  int64_t buf[512];
  indptr[0] = 0;
  for (int64_t i = 0; i < nraw; ++i) {
    const int n =
        row_neighbors(NSH, acells, vptr.data(), vcell.data(), i, buf, 512);
    if (n < 0) return -1;
    indptr[i + 1] = indptr[i] + n;
  }
  return indptr[nraw];
}

template <int DIM>
void assemble_impl(int64_t nc, int64_t nraw, const double *vertices,
                   const int64_t *cells, const int64_t *acells,
                   const int64_t *indptr, int64_t *indices, double *mij,
                   double *cij, double *mii, double *cii, double *lumped,
                   double *measure) {
  constexpr int NSH = 1 << DIM;
  constexpr int NQ = 1 << DIM;
  static const Q1<DIM> q1;

  std::vector<int64_t> vptr, vcell;
  vertex_cells(NSH, nc, nraw, acells, vptr, vcell);

  // fill sorted column indices
  {
    int64_t buf[512];
    for (int64_t i = 0; i < nraw; ++i) {
      const int n =
          row_neighbors(NSH, acells, vptr.data(), vcell.data(), i, buf, 512);
      std::memcpy(indices + indptr[i], buf, n * sizeof(int64_t));
    }
  }

  const int64_t nnz = indptr[nraw];
  std::memset(mij, 0, nnz * sizeof(double));
  std::memset(cij, 0, nnz * DIM * sizeof(double));
  std::memset(mii, 0, nraw * sizeof(double));
  std::memset(cii, 0, nraw * DIM * sizeof(double));
  double meas = 0.0;

  for (int64_t c = 0; c < nc; ++c) {
    // geometry from the RAW cell vertices (identical to the numpy path,
    // which indexes mesh.vertices[cells]); the scatter targets are the
    // master-mapped acells:
    double X[NSH][DIM];
    for (int s = 0; s < NSH; ++s)
      for (int d = 0; d < DIM; ++d)
        X[s][d] = vertices[cells[c * NSH + s] * DIM + d];

    double cm[NSH][NSH];
    double cc[NSH][NSH][DIM];
    std::memset(cm, 0, sizeof(cm));
    std::memset(cc, 0, sizeof(cc));

    for (int q = 0; q < NQ; ++q) {
      // J[e][d] = d x_e / d xi_d
      double J[DIM][DIM];
      for (int e = 0; e < DIM; ++e)
        for (int d = 0; d < DIM; ++d) {
          double a = 0.0;
          for (int s = 0; s < NSH; ++s) a += q1.dN[q][s][d] * X[s][e];
          J[e][d] = a;
        }
      double Jinv[DIM][DIM], det;
      inv_det<DIM>(J, Jinv, det);
      const double jxw = det * q1.w[q];
      meas += jxw;
      // physical gradients: g[s][e] = dN[s][d] Jinv[d][e]
      double g[NSH][DIM];
      for (int s = 0; s < NSH; ++s)
        for (int e = 0; e < DIM; ++e) {
          double a = 0.0;
          for (int d = 0; d < DIM; ++d) a += q1.dN[q][s][d] * Jinv[d][e];
          g[s][e] = a;
        }
      for (int i = 0; i < NSH; ++i) {
        const double niw = q1.N[q][i] * jxw;
        for (int j = 0; j < NSH; ++j) {
          cm[i][j] += niw * q1.N[q][j];
          for (int e = 0; e < DIM; ++e) cc[i][j][e] += niw * g[j][e];
        }
      }
    }

    // scatter
    for (int i = 0; i < NSH; ++i) {
      const int64_t ri = acells[c * NSH + i];
      const int64_t *row = indices + indptr[ri];
      const int rl = static_cast<int>(indptr[ri + 1] - indptr[ri]);
      for (int j = 0; j < NSH; ++j) {
        const int64_t rj = acells[c * NSH + j];
        if (rj == ri) {
          mii[ri] += cm[i][j];
          for (int e = 0; e < DIM; ++e) cii[ri * DIM + e] += cc[i][j][e];
        } else {
          const int64_t k =
              std::lower_bound(row, row + rl, rj) - row + indptr[ri];
          mij[k] += cm[i][j];
          for (int e = 0; e < DIM; ++e) cij[k * DIM + e] += cc[i][j][e];
        }
      }
    }
  }

  for (int64_t i = 0; i < nraw; ++i) {
    double l = mii[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) l += mij[k];
    lumped[i] = l;
  }
  *measure = meas;
}

}  // namespace

extern "C" {

int64_t ryujin_q1_count(int dim, int64_t nc, int64_t nraw,
                        const int64_t *acells, int64_t *indptr) {
  switch (dim) {
    case 1: return count_impl<1>(nc, nraw, acells, indptr);
    case 2: return count_impl<2>(nc, nraw, acells, indptr);
    case 3: return count_impl<3>(nc, nraw, acells, indptr);
  }
  return -1;
}

int ryujin_q1_assemble(int dim, int64_t nc, int64_t nraw,
                       const double *vertices, const int64_t *cells,
                       const int64_t *acells, const int64_t *indptr,
                       int64_t *indices, double *mij, double *cij,
                       double *mii, double *cii, double *lumped,
                       double *measure) {
  switch (dim) {
    case 1:
      assemble_impl<1>(nc, nraw, vertices, cells, acells, indptr, indices,
                       mij, cij, mii, cii, lumped, measure);
      return 0;
    case 2:
      assemble_impl<2>(nc, nraw, vertices, cells, acells, indptr, indices,
                       mij, cij, mii, cii, lumped, measure);
      return 0;
    case 3:
      assemble_impl<3>(nc, nraw, vertices, cells, acells, indptr, indices,
                       mij, cij, mii, cii, lumped, measure);
      return 0;
  }
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Structured-canvas edge packing (native core of
// ryujin_tpu_torch/offline/structured.py pack_structured): for every CSR edge
// (i, j) of a real row, compute the lattice delta wrapped into {-1,0,1},
// map it to the negation-symmetric offset slot, and scatter (cij, mij,
// mask) into the [n_pad, K, ...] canvas arrays.
// ---------------------------------------------------------------------------

extern "C" int ryujin_pack_edges(
    int dim, int64_t n_rows, const int64_t *rows, const int64_t *indptr,
    const int64_t *indices, const int64_t *si /* [n_raw, dim] */,
    const int64_t *logical /* [dim] */, const int64_t *flat /* [n_raw] */,
    const double *cij_in /* [nnz, dim] */, const double *mij_in /* [nnz] */,
    int64_t K, double *cij_out /* [n_pad, K, dim] */,
    double *mij_out /* [n_pad, K] */, double *mask_out /* [n_pad, K] */) {
  // offset slot lookup: slot = lut[base3] with base3 accumulated over
  // canvas axes (axis = 0 slowest), digit = delta + 1; offsets enumerate
  // all nonzero {-1,0,1}^dim lexicographically (lattice_offsets).
  int pow3 = 1;
  for (int d = 0; d < dim; ++d) pow3 *= 3;
  std::vector<int> lut(pow3, -1);
  {
    int k = 0;
    // lexicographic enumeration over {-1,0,1}^dim, skipping all-zero:
    for (int code = 0; code < pow3; ++code) {
      // code digits, most-significant first, map to offset entries
      int digits[8];
      int c = code;
      for (int d = dim - 1; d >= 0; --d) {
        digits[d] = c % 3;
        c /= 3;
      }
      bool zero = true;
      for (int d = 0; d < dim; ++d) zero &= (digits[d] == 1);
      if (zero) continue;
      lut[code] = k++;
    }
  }

  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t i = rows[r];
    const int64_t ci = flat[i];
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e) {
      const int64_t j = indices[e];
      int base3 = 0;
      for (int axis = 0; axis < dim; ++axis) {
        const int d = dim - 1 - axis;  // canvas axis -> lattice dim
        const int64_t P = logical[d];
        int64_t dd = (si[j * dim + d] - si[i * dim + d]) % P;
        if (dd < 0) dd += P;
        if (dd > P / 2) dd -= P;
        if (dd < -1 || dd > 1) return 1;  // beyond lattice neighborhood
        base3 = 3 * base3 + static_cast<int>(dd + 1);
      }
      const int slot = lut[base3];
      if (slot < 0) return 2;  // degenerate zero-offset edge
      const int64_t o = ci * K + slot;
      for (int d = 0; d < dim; ++d)
        cij_out[o * dim + d] = cij_in[e * dim + d];
      mij_out[o] = mij_in[e];
      mask_out[o] = 1.0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Boundary-face owner lookup (native core of assembly._face_cell_centers):
// for each face, find a cell containing all its vertices via the
// vertex->cells adjacency of the face's first vertex.
// ---------------------------------------------------------------------------

extern "C" int ryujin_face_owners(int dim, int64_t nc, int64_t nraw,
                                  const int64_t *cells, int64_t nf, int nfv,
                                  const int64_t *faces /* [nf, nfv] */,
                                  int64_t *owners /* [nf] */) {
  const int nsh = 1 << dim;
  std::vector<int64_t> vptr, vcell;
  vertex_cells(nsh, nc, nraw, cells, vptr, vcell);
  for (int64_t f = 0; f < nf; ++f) {
    const int64_t *fv = faces + f * nfv;
    const int64_t v0 = fv[0];
    int64_t found = -1;
    for (int64_t p = vptr[v0]; p < vptr[v0 + 1] && found < 0; ++p) {
      const int64_t c = vcell[p];
      const int64_t *cv = cells + c * nsh;
      bool all = true;
      for (int t = 1; t < nfv && all; ++t) {
        bool in = false;
        for (int s = 0; s < nsh; ++s) in |= (cv[s] == fv[t]);
        all &= in;
      }
      if (all) found = c;
    }
    if (found < 0) return 1;
    owners[f] = found;
  }
  return 0;
}
