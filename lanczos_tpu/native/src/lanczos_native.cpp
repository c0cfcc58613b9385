// Native host-side assembly/packing engine.
//
// Counterpart of the reference's C++ host layer: operator
// assembly (reference `source/matrix_a/build_A_ell.hpp:10-255`), ELL
// packing and layout transforms (reference `Ell_matrix::change_order` /
// `padding`, `source/objects/ell_matrix.hpp:362-448`).  The JAX side
// computes the small separable coefficient vectors; these O(nnz) loops
// fill the big arrays with OpenMP, replacing the Python row loops that
// are unusable at the 24.6M-row benchmark size.
//
// Built as a plain shared library (g++ -O3 -fopenmp -shared) and loaded
// via ctypes — no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// CSR -> padded ELL (data + int32 column plane).
// Rows beyond n (padding) keep data 0 / idx 0.
// ---------------------------------------------------------------------------
void ell_from_csr_f32(
    int64_t n_rows, int64_t rows_pad, int64_t width,
    const int64_t* indptr, const int64_t* indices, const double* data,
    float* out_data, int32_t* out_idx)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < rows_pad; ++i) {
        float* dst = out_data + i * width;
        int32_t* idx = out_idx + i * width;
        if (i < n_rows) {
            int64_t lo = indptr[i], hi = indptr[i + 1];
            int64_t k = 0;
            for (int64_t j = lo; j < hi && k < width; ++j, ++k) {
                dst[k] = static_cast<float>(data[j]);
                idx[k] = static_cast<int32_t>(indices[j]);
            }
            for (; k < width; ++k) { dst[k] = 0.f; idx[k] = 0; }
        } else {
            for (int64_t k = 0; k < width; ++k) { dst[k] = 0.f; idx[k] = 0; }
        }
    }
}

void ell_from_csr_f64(
    int64_t n_rows, int64_t rows_pad, int64_t width,
    const int64_t* indptr, const int64_t* indices, const double* data,
    double* out_data, int32_t* out_idx)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < rows_pad; ++i) {
        double* dst = out_data + i * width;
        int32_t* idx = out_idx + i * width;
        if (i < n_rows) {
            int64_t lo = indptr[i], hi = indptr[i + 1];
            int64_t k = 0;
            for (int64_t j = lo; j < hi && k < width; ++j, ++k) {
                dst[k] = data[j];
                idx[k] = static_cast<int32_t>(indices[j]);
            }
            for (; k < width; ++k) { dst[k] = 0.0; idx[k] = 0; }
        } else {
            for (int64_t k = 0; k < width; ++k) { dst[k] = 0.0; idx[k] = 0; }
        }
    }
}

// ---------------------------------------------------------------------------
// CSR -> halo-localized ELL: column indices become positions in the
// halo-extended local window  [left_halo | local rows | right_halo]
// of each shard (lanczos_tpu.parallel.dist_operator.HaloShardedEll).
// Pad entries point at `halo` (first local row) with data 0.
// ---------------------------------------------------------------------------
void halo_ell_from_csr_f32(
    int64_t n_rows, int64_t rows_pad, int64_t width,
    int64_t rows_loc, int64_t halo,
    const int64_t* indptr, const int64_t* indices, const double* data,
    float* out_data, int32_t* out_idx)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < rows_pad; ++i) {
        float* dst = out_data + i * width;
        int32_t* idx = out_idx + i * width;
        int64_t base = (i / rows_loc) * rows_loc;
        for (int64_t k = 0; k < width; ++k) { dst[k] = 0.f; idx[k] = (int32_t)halo; }
        if (i < n_rows) {
            int64_t lo = indptr[i], hi = indptr[i + 1];
            int64_t k = 0;
            for (int64_t j = lo; j < hi && k < width; ++j, ++k) {
                dst[k] = static_cast<float>(data[j]);
                idx[k] = static_cast<int32_t>(indices[j] - base + halo);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Direct Maxwell ELL assembly.
//
// The operator A = D @ diag(w) has exactly 4 nonzeros per row: 2 curl
// blocks per output component x 2 taps per block.  A tap is
//   (in_comp, axis, offset) + separable weights (wz, wy, wx) over the
// OUTPUT component's extents (column weight folded in, exactly the
// layout `lanczos_tpu.models.maxwell._build_taps` produces).  Python
// passes the tap table; this enumerates all rows in parallel.
//
// Tap table encoding per tap t (n_taps entries):
//   tap_meta[4*t + 0] = out_comp, [1] = in_comp, [2] = axis, [3] = offset
//   wz/wy/wx: concatenated per-tap weight vectors with offsets in
//   w*_off[t] (lengths implied by the output component extents).
// Component geometry: comp_shape[3*c + {0,1,2}] = (zl, yl, xl),
// comp_off[c] = flat offset of component c in the state vector.
// ---------------------------------------------------------------------------
void maxwell_ell_f32(
    int64_t n_rows, int64_t rows_pad,
    int64_t n_taps,
    const int64_t* tap_meta,
    const double* wz, const int64_t* wz_off,
    const double* wy, const int64_t* wy_off,
    const double* wx, const int64_t* wx_off,
    const int64_t* comp_shape, const int64_t* comp_off,
    float* out_data, int32_t* out_idx)
{
    // zero-fill (including pad rows)
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < rows_pad * 4; ++i) { out_data[i] = 0.f; out_idx[i] = 0; }

    for (int64_t t = 0; t < n_taps; ++t) {
        int64_t oc = tap_meta[4 * t + 0];
        int64_t ic = tap_meta[4 * t + 1];
        int64_t ax = tap_meta[4 * t + 2];
        int64_t off = tap_meta[4 * t + 3];
        int64_t zl = comp_shape[3 * oc], yl = comp_shape[3 * oc + 1],
                xl = comp_shape[3 * oc + 2];
        int64_t izl = comp_shape[3 * ic], iyl = comp_shape[3 * ic + 1],
                ixl = comp_shape[3 * ic + 2];
        int64_t obase = comp_off[oc], ibase = comp_off[ic];
        const double* tz = wz + wz_off[t];
        const double* ty = wy + wy_off[t];
        const double* tx = wx + wx_off[t];
        // slot for this tap within the row's 4 entries: 2 taps per block,
        // blocks ordered by tap table order per output comp.
        // Count how many earlier taps share this out comp:
        int64_t slot = 0;
        for (int64_t s = 0; s < t; ++s)
            if (tap_meta[4 * s] == oc) ++slot;

#pragma omp parallel for collapse(2) schedule(static)
        for (int64_t z = 0; z < zl; ++z) {
            for (int64_t y = 0; y < yl; ++y) {
                for (int64_t x = 0; x < xl; ++x) {
                    int64_t iz = z, iy = y, ix = x;
                    if (ax == 0) iz += off;
                    else if (ax == 1) iy += off;
                    else ix += off;
                    double v = tz[z] * ty[y] * tx[x];
                    int64_t row = obase + (z * yl + y) * xl + x;
                    float* dst = out_data + row * 4;
                    int32_t* idx = out_idx + row * 4;
                    if (iz < 0 || iy < 0 || ix < 0 ||
                        iz >= izl || iy >= iyl || ix >= ixl || v == 0.0) {
                        dst[slot] = 0.f; idx[slot] = 0;
                    } else {
                        int64_t col = ibase + (iz * iyl + iy) * ixl + ix;
                        dst[slot] = static_cast<float>(v);
                        idx[slot] = static_cast<int32_t>(col);
                    }
                }
            }
        }
    }
}

}  // extern "C"
