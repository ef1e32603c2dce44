"""ctypes bindings to the native sparse-numerics engine (native/ecsparse.cpp).

Same pattern as io/native.py: shared library next to this module, named
after its source's hash and built with g++ on first use, graceful
``None`` when unavailable so callers fall back to the (slow,
identical-result) numpy paths."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_build import load

__all__ = ["get_lib", "ilu0_native", "ilu0_solve_native"]

_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = load("ecsparse.cpp", os.path.dirname(os.path.abspath(__file__)), "ecsparse")
    if lib is None:
        return None
    lib.ec3d_ilu0.restype = ctypes.c_int64
    lib.ec3d_ilu0.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p]
    lib.ec3d_ilu0_solve.restype = ctypes.c_int64
    lib.ec3d_ilu0_solve.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p, _f64p]
    _lib = lib
    return lib


def ilu0_native(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """In-place ILU(0) on (indptr, cols, vals); returns factored vals or
    None when the native library is unavailable.  Raises on zero pivot."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.array(vals, np.float64, copy=True, order="C")
    rc = lib.ec3d_ilu0(
        indptr.shape[0] - 1,
        indptr.ctypes.data_as(_i64p), cols.ctypes.data_as(_i32p),
        out.ctypes.data_as(_f64p),
    )
    if rc > 0:
        raise ZeroDivisionError(f"ILU(0): zero or missing pivot in row {rc - 1}")
    if rc < 0:
        raise ValueError(f"ILU(0): unsorted columns in row {-rc - 1}")
    return out


def ilu0_solve_native(indptr, cols, fvals, b):
    """Exact sequential L/U solve on packed ILU(0) factors; returns x or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    fvals = np.ascontiguousarray(fvals, np.float64)
    x = np.array(b, np.float64, copy=True, order="C")
    rc = lib.ec3d_ilu0_solve(
        indptr.shape[0] - 1,
        indptr.ctypes.data_as(_i64p), cols.ctypes.data_as(_i32p),
        fvals.ctypes.data_as(_f64p), x.ctypes.data_as(_f64p),
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0) solve: zero pivot in row {rc - 1}")
    return x
