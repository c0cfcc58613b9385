"""Native (C++) host-side assembly engine, loaded via ctypes.

Compiled on demand from `src/lanczos_native.cpp` with g++ (-O3 -fopenmp);
every entry point has a pure-NumPy fallback so the library works without
a toolchain (set LANCZOS_TPU_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "lanczos_native.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "_lanczos_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        _SRC, "-o", _LIB,
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=300
        )
        return True
    except Exception:
        try:  # retry without -march=native / openmp (portability)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _LIB],
                check=True, capture_output=True, text=True, timeout=300,
            )
            return True
        except Exception:
            return False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("LANCZOS_TPU_NO_NATIVE"):
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ell_from_csr_f32.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, f64p, f32p, i32p,
        ]
        lib.ell_from_csr_f64.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, f64p, f64p, i32p,
        ]
        lib.halo_ell_from_csr_f32.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, f64p, f32p, i32p,
        ]
        lib.maxwell_ell_f32.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, f64p, i64p, f64p, i64p, f64p, i64p, i64p, i64p,
            f32p, i32p,
        ]
        _lib = lib
        return _lib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def ell_from_csr(indptr, indices, data, n_rows, rows_pad, width, dtype):
    """Padded ELL planes from CSR arrays.  Returns (data, idx) or None if
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    dat = np.ascontiguousarray(data, np.float64)
    idx_out = np.empty((rows_pad, width), np.int32)
    if np.dtype(dtype) == np.float32:
        out = np.empty((rows_pad, width), np.float32)
        lib.ell_from_csr_f32(
            n_rows, rows_pad, width,
            _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
            _p(dat, ctypes.c_double),
            _p(out, ctypes.c_float), _p(idx_out, ctypes.c_int32),
        )
    else:
        out = np.empty((rows_pad, width), np.float64)
        lib.ell_from_csr_f64(
            n_rows, rows_pad, width,
            _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
            _p(dat, ctypes.c_double),
            _p(out, ctypes.c_double), _p(idx_out, ctypes.c_int32),
        )
    return out, idx_out


def halo_ell_from_csr(indptr, indices, data, n_rows, rows_pad, width,
                      rows_loc, halo):
    """Halo-localized float32 ELL planes, or None."""
    lib = load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    dat = np.ascontiguousarray(data, np.float64)
    out = np.empty((rows_pad, width), np.float32)
    idx_out = np.empty((rows_pad, width), np.int32)
    lib.halo_ell_from_csr_f32(
        n_rows, rows_pad, width, rows_loc, halo,
        _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
        _p(dat, ctypes.c_double),
        _p(out, ctypes.c_float), _p(idx_out, ctypes.c_int32),
    )
    return out, idx_out


def maxwell_ell(descs, arrays, comp_shapes, n_rows, rows_pad):
    """Direct float32 ELL assembly of the Maxwell operator from the tap
    table (see models.maxwell._build_taps).  Returns (data, idx) or None."""
    lib = load()
    if lib is None:
        return None
    n_taps = len(descs)
    tap_meta = np.asarray(
        [[oc, ic, ax, off] for (oc, ic, ax, off) in descs], np.int64
    ).reshape(-1)
    wz = np.concatenate([np.asarray(t[0], np.float64) for t in arrays])
    wy = np.concatenate([np.asarray(t[1], np.float64) for t in arrays])
    wx = np.concatenate([np.asarray(t[2], np.float64) for t in arrays])
    wz_off = np.cumsum([0] + [len(t[0]) for t in arrays[:-1]]).astype(np.int64)
    wy_off = np.cumsum([0] + [len(t[1]) for t in arrays[:-1]]).astype(np.int64)
    wx_off = np.cumsum([0] + [len(t[2]) for t in arrays[:-1]]).astype(np.int64)
    comp_shape = np.asarray(comp_shapes, np.int64).reshape(-1)
    sizes = [int(np.prod(s)) for s in comp_shapes]
    comp_off = np.cumsum([0] + sizes[:-1]).astype(np.int64)
    out = np.empty((rows_pad, 4), np.float32)
    idx_out = np.empty((rows_pad, 4), np.int32)
    lib.maxwell_ell_f32(
        n_rows, rows_pad, n_taps,
        _p(tap_meta, ctypes.c_int64),
        _p(wz, ctypes.c_double), _p(wz_off, ctypes.c_int64),
        _p(wy, ctypes.c_double), _p(wy_off, ctypes.c_int64),
        _p(wx, ctypes.c_double), _p(wx_off, ctypes.c_int64),
        _p(comp_shape, ctypes.c_int64), _p(comp_off, ctypes.c_int64),
        _p(out, ctypes.c_float), _p(idx_out, ctypes.c_int32),
    )
    return out, idx_out
