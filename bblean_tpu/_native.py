r"""Loader for the native (C++) host library.

The native library ``libbblean_native.so`` (built from ``bblean_tpu/csrc`` via
``python setup.py build_native`` or the Makefile) provides:

- SIMD popcount / Tanimoto / iSIM kernels for the host path (the device path uses
  ``bblean_tpu.ops`` instead), and
- a full native implementation of the exact serial-equivalent BitBirch insert
  loop (``bb_exact_fit``), which the reference keeps in Python
  (reference hot loop: ``bblean/bitbirch.py:305-357``).

Bindings use ``ctypes`` (no pybind11 dependency).  Importing the wrapped
functions raises ImportError when the library is absent, which makes the
facade in ``bblean_tpu.similarity`` fall back to NumPy cleanly.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

_LIB_NAMES = ("libbblean_native.so",)
_SEARCH_DIRS = (
    Path(__file__).parent / "csrc" / "build",
    Path(__file__).parent,
)

_lib: ctypes.CDLL | None = None
_load_attempted = False


def native_lib_path() -> Path | None:
    r"""Path of the built native library, or None when not built."""
    for d in _SEARCH_DIRS:
        for name in _LIB_NAMES:
            p = d / name
            if p.exists():
                return p
    return None


def _load() -> ctypes.CDLL:
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        raise ImportError("native library failed to load previously")
    _load_attempted = True
    path = native_lib_path()
    if path is None:
        raise ImportError("bblean_tpu native library is not built")
    lib = ctypes.CDLL(os.fspath(path))
    _configure(lib)
    _lib = lib
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64

    lib.bb_jt_isim_from_sum_u64.restype = ctypes.c_double
    lib.bb_jt_isim_from_sum_u64.argtypes = [u64p, i64, i64]

    lib.bb_jt_sim_arr_vec_packed.restype = None
    lib.bb_jt_sim_arr_vec_packed.argtypes = [u8p, u8p, i64, i64, f64p]

    lib.bb_most_dissimilar_packed.restype = None
    lib.bb_most_dissimilar_packed.argtypes = [
        u8p, i64, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), f64p, f64p,
    ]


def _as_c(arr: np.ndarray, ctype: type) -> ctypes._Pointer:
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def jt_isim_from_sum(linear_sum: NDArray[np.integer], n_objects: int) -> float:
    r"""Native iSIM from a linear sum (see ``_np_similarity.jt_isim_from_sum``)."""
    lib = _load()
    if n_objects < 2:
        import warnings

        warnings.warn(
            f"Invalid n_objects = {n_objects} in isim. Expected n_objects >= 2",
            RuntimeWarning,
            stacklevel=2,
        )
        return np.nan
    x = np.ascontiguousarray(linear_sum, dtype=np.uint64)
    return lib.bb_jt_isim_from_sum_u64(_as_c(x, ctypes.c_uint64), len(x), n_objects)


def _jt_sim_arr_vec_packed(
    x: NDArray[np.uint8], y: NDArray[np.uint8]
) -> NDArray[np.float64]:
    r"""Native packed Tanimoto of array rows vs one vector."""
    lib = _load()
    if x.ndim != 2 or y.ndim != 1:
        raise ValueError("Expected a 2D array and a 1D vector as inputs")
    x = np.ascontiguousarray(x, dtype=np.uint8)
    y = np.ascontiguousarray(y, dtype=np.uint8)
    out = np.empty(len(x), dtype=np.float64)
    lib.bb_jt_sim_arr_vec_packed(
        _as_c(x, ctypes.c_uint8),
        _as_c(y, ctypes.c_uint8),
        x.shape[0],
        x.shape[1],
        _as_c(out, ctypes.c_double),
    )
    return out


def jt_most_dissimilar_packed(
    Y: NDArray[np.uint8], n_features: int | None = None
) -> tuple[np.integer, np.integer, NDArray[np.float64], NDArray[np.float64]]:
    r"""Native O(N) most-dissimilar pair heuristic (packed input)."""
    lib = _load()
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    n, b = Y.shape
    nf = n_features if n_features is not None else b * 8
    i1 = ctypes.c_int64()
    i2 = ctypes.c_int64()
    sims1 = np.empty(n, dtype=np.float64)
    sims2 = np.empty(n, dtype=np.float64)
    lib.bb_most_dissimilar_packed(
        _as_c(Y, ctypes.c_uint8), n, b, nf,
        ctypes.byref(i1), ctypes.byref(i2),
        _as_c(sims1, ctypes.c_double), _as_c(sims2, ctypes.c_double),
    )
    return np.int64(i1.value), np.int64(i2.value), sims1, sims2


def jt_isim_unpacked(arr: NDArray[np.integer]) -> float:
    r"""iSIM of unpacked fps (native reduction of the linear sum)."""
    return jt_isim_from_sum(np.sum(arr, axis=0, dtype=np.uint64), len(arr))


def jt_isim_packed(fps: NDArray[np.integer], n_features: int | None = None) -> float:
    r"""iSIM of packed fps (native reduction of the linear sum)."""
    from bblean_tpu.fingerprints import unpack_fingerprints

    return jt_isim_from_sum(
        np.sum(unpack_fingerprints(fps, n_features), axis=0, dtype=np.uint64),
        len(fps),
    )

def available() -> bool:
    r"""Whether the native library can be loaded on this host."""
    try:
        _load()
        return True
    except (ImportError, OSError):
        return False
