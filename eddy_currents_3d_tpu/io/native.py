"""ctypes bindings to the native IO engine (native/ecio.cpp).

The shared library lives next to this module under a name keyed on the
source's hash and is built with g++ on first use (utils/native_build.py).
All entry points return None gracefully when the native path is
unavailable so callers fall back to the numpy writers — outputs are
byte-identical either way (tested)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_build import load

__all__ = ["get_lib", "write_field_native", "write_src_native"]

_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = load("ecio.cpp", os.path.dirname(os.path.abspath(__file__)), "ecio")
    if lib is None:
        return None
    lib.ec3d_write_field.restype = ctypes.c_int
    lib.ec3d_write_field.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_void_p, ctypes.c_double,
    ]
    lib.ec3d_write_src.restype = ctypes.c_int
    lib.ec3d_write_src.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def write_field_native(path, delta, A, carry, cond_mask, eddy_scale) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    A = np.ascontiguousarray(A, np.float64)
    carry = np.ascontiguousarray(carry, np.float64)
    nz, ny, nx = A.shape[1:]
    if cond_mask is not None:
        cond = np.ascontiguousarray(cond_mask, np.uint8)
        cond_ptr = cond.ctypes.data_as(ctypes.c_void_p)
    else:
        cond = None
        cond_ptr = None
    rc = lib.ec3d_write_field(
        path.encode(), nx, ny, nz,
        float(delta[0]), float(delta[1]), float(delta[2]),
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        carry.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cond_ptr, float(eddy_scale),
    )
    return rc == 0


def write_src_native(path, delta, shape_xyz, cells_per_fun, values, dirs) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    nx, ny, _ = shape_xyz
    cells = np.ascontiguousarray(
        np.concatenate([np.asarray(c, np.int64) for c in cells_per_fun])
        if cells_per_fun else np.zeros(0, np.int64)
    )
    counts = np.asarray([len(c) for c in cells_per_fun], np.int64)
    vals = np.asarray(values, np.float64)
    dmap = np.asarray([{"X": 0, "Y": 1, "Z": 2}[d] for d in dirs], np.int32)
    rc = lib.ec3d_write_src(
        path.encode(), nx, ny,
        float(delta[0]), float(delta[1]), float(delta[2]),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(cells_per_fun),
    )
    return rc == 0
