"""Host-side data packing — native C++ fast path with numpy fallback.

The reference's native (Rust) layer exists for compute speed; here that role
is filled by XLA and the Pallas kernel on the accelerator, and the host-side residue is data packing: turning
user numpy arrays / long-format frames into the dense (values, mask) pair the
device wants.  For large datasets that packing is memory-bandwidth-bound in
numpy (multiple passes + temporaries), so we provide a multithreaded C++
extension (`packing.cpp`, built on demand with g++) and fall back to numpy
transparently when it is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

from ..config import config

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_HERE, "_ppca_packing.so")
_SRC_PATH = os.path.join(_HERE, "packing.cpp")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _try_build() -> Optional[str]:
    """Compile packing.cpp with g++ if the shared object is missing/stale."""
    if not os.path.exists(_SRC_PATH):
        return None
    try:
        if (
            os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC_PATH)
        ):
            return _SO_PATH
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            _SRC_PATH, "-o", _SO_PATH + ".tmp",
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(_SO_PATH + ".tmp", _SO_PATH)
        return _SO_PATH
    except Exception:
        return None


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed or not config.use_native:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _try_build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.ppca_mask_non_finite_f64.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
            ]
            lib.ppca_mask_non_finite_f64.restype = None
            lib.ppca_scatter_long_f64.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.ppca_scatter_long_f64.restype = None
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib


def mask_non_finite(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values, mask): mask=False and value=0 where arr is NaN/inf.

    One fused multithreaded pass in C++; numpy fallback does the same in two
    vectorized passes.
    """
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    lib = _get_lib() if arr.size >= 1 << 16 else None
    if lib is not None:
        filled = np.empty_like(arr)
        mask = np.empty(arr.shape, dtype=np.bool_)
        lib.ppca_mask_non_finite_f64(
            arr.ctypes.data, filled.ctypes.data, mask.ctypes.data, arr.size
        )
        return filled, mask
    mask = np.isfinite(arr)
    return np.where(mask, arr, 0.0), mask


def scatter_long_to_dense(
    sample_idx: np.ndarray,
    dim_idx: np.ndarray,
    values: np.ndarray,
    n_samples: int,
    n_dims: int,
) -> np.ndarray:
    """Scatter long-format (sample, dim, value) triplets into a dense
    NaN-initialized (n_samples, n_dims) array — the hot loop of the DataFrame
    adapters (`python/ppca_rs/__init__.py:183-186,244-248` in the reference is
    a per-group Python loop)."""
    sample_idx = np.ascontiguousarray(sample_idx, dtype=np.int64)
    dim_idx = np.ascontiguousarray(dim_idx, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.full((n_samples, n_dims), np.nan, dtype=np.float64)
    lib = _get_lib() if values.size >= 1 << 16 else None
    if lib is not None:
        lib.ppca_scatter_long_f64(
            sample_idx.ctypes.data, dim_idx.ctypes.data, values.ctypes.data,
            values.size, out.ctypes.data, n_dims,
        )
        return out
    out[sample_idx, dim_idx] = values
    return out
