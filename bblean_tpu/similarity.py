r"""Public molecular-similarity API (host side).

Facade over the backend kernels.  Selection order at import time (mirrors the
reference facade ``bblean/similarity.py:47-103``):

1. Native C++ kernels (``bblean_tpu._native``), unless disabled through the
   ``BBLEAN_TPU_NO_EXTENSIONS`` (or legacy ``BITBIRCH_NO_EXTENSIONS``) env var.
2. NumPy reference kernels (``bblean_tpu._np_similarity``), always available.

Large-scale batched similarity on the device lives in ``bblean_tpu.ops`` — this
module is the scalar/host surface used by the exact tree engine, metrics and
analysis utilities.
"""

from __future__ import annotations

import os

import numpy as np
from numpy.typing import NDArray

from bblean_tpu._np_similarity import (
    centroid,
    centroid_from_sum,
    jt_compl_isim,
    jt_isim_medoid,
)
from bblean_tpu.fingerprints import unpack_fingerprints

__all__ = [
    "jt_isim_from_sum",
    "jt_isim",
    "jt_sim_packed",
    "jt_most_dissimilar_packed",
    "jt_isim_radius_from_sum",
    "jt_isim_radius_compl_from_sum",
    "jt_isim_diameter_from_sum",
    "jt_isim_radius",
    "jt_isim_radius_compl",
    "jt_isim_diameter",
    "centroid_from_sum",
    "centroid",
    "jt_isim_medoid",
    "jt_compl_isim",
    "jt_stratified_sampling",
    "jt_sim_matrix_packed",
    "estimate_jt_std",
]

from bblean_tpu.utils import extensions_disabled_by_env

_NO_NATIVE = extensions_disabled_by_env()

_native_loaded = False
if not _NO_NATIVE:
    try:
        from bblean_tpu import _native as _native_mod

        if _native_mod.available():
            from bblean_tpu._native import (  # type: ignore
                jt_isim_from_sum,
                jt_isim_packed,
                jt_isim_unpacked,
                _jt_sim_arr_vec_packed,
                jt_most_dissimilar_packed,
            )

            _native_loaded = True
    except ImportError:
        pass

if not _native_loaded:
    from bblean_tpu._np_similarity import (  # type: ignore # noqa: F811
        jt_isim_from_sum,
        jt_isim_packed,
        jt_isim_unpacked,
        _jt_sim_arr_vec_packed,
        jt_most_dissimilar_packed,
    )


def jt_isim(
    fps: NDArray[np.integer],
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> float:
    r"""Average Tanimoto similarity of a set of fingerprints, using iSIM."""
    if input_is_packed:
        return jt_isim_packed(fps, n_features)
    return jt_isim_unpacked(fps)


def _uint64_linear_sum(
    arr: NDArray[np.integer], input_is_packed: bool, n_features: int | None
) -> NDArray[np.uint64]:
    if input_is_packed:
        arr = unpack_fingerprints(arr, n_features)
    return np.sum(arr, axis=0, dtype=np.uint64)


def jt_isim_diameter(
    arr: NDArray[np.integer],
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> float:
    r"""Tanimoto diameter of a set of fingerprints (1 - iSIM)."""
    return jt_isim_diameter_from_sum(
        _uint64_linear_sum(arr, input_is_packed, n_features), len(arr)
    )


def jt_isim_radius(
    arr: NDArray[np.integer],
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> float:
    r"""Tanimoto radius of a set of fingerprints."""
    return jt_isim_radius_from_sum(
        _uint64_linear_sum(arr, input_is_packed, n_features), len(arr)
    )


def jt_isim_radius_compl(
    arr: NDArray[np.integer],
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> float:
    r"""Complement of the Tanimoto radius of a set of fingerprints."""
    return jt_isim_radius_compl_from_sum(
        _uint64_linear_sum(arr, input_is_packed, n_features), len(arr)
    )


def jt_isim_radius_compl_from_sum(ls: NDArray[np.integer], n: int) -> float:
    r"""Complement of the Tanimoto radius, from a linear sum and a count.

    Measures the similarity of the set to its own majority-vote centroid:
    ``((n+1) * isim(ls + c, n+1) - (n-1) * isim(ls, n)) / 2``.
    """
    unpacked_centroid = centroid_from_sum(ls, n, pack=False)
    # Linear sums may arrive as any (non-negative) integer dtype
    ls_u64 = ls.astype(np.uint64, copy=False)
    ls_with_centroid = np.add(ls_u64, unpacked_centroid, dtype=np.uint64)
    isim_n = jt_isim_from_sum(ls, n)
    isim_n1 = jt_isim_from_sum(ls_with_centroid, n + 1)
    return (isim_n1 * (n + 1) - isim_n * (n - 1)) / 2


def jt_isim_radius_from_sum(ls: NDArray[np.integer], n: int) -> float:
    r"""Tanimoto radius from a linear sum and a count."""
    return 1 - jt_isim_radius_compl_from_sum(ls, n)


def jt_isim_diameter_from_sum(ls: NDArray[np.integer], n: int) -> float:
    r"""Tanimoto diameter from a linear sum and a count (1 - iSIM)."""
    return 1 - jt_isim_from_sum(ls, n)


def jt_sim_packed(
    x: NDArray[np.uint8], y: NDArray[np.uint8]
) -> NDArray[np.float64]:
    r"""Tanimoto similarity between packed fingerprints.

    Accepts (vector, vector), (array, vector) or (vector, array) inputs.
    """
    if x.ndim == 1 and y.ndim == 1:
        return _jt_sim_arr_vec_packed(x.reshape(1, -1), y)[0]
    if x.ndim == 2:
        return _jt_sim_arr_vec_packed(x, y)
    if y.ndim == 2:
        return _jt_sim_arr_vec_packed(y, x)
    raise ValueError("Expected either two 1D vectors, or one 1D vector and one 2D array")


def jt_sim_matrix_packed(arr: NDArray[np.uint8]) -> NDArray[np.float64]:
    r"""Full symmetric Tanimoto similarity matrix of a packed fp array."""
    n = len(arr)
    matrix = np.ones((n, n), dtype=np.float64)
    for i in range(n):
        row = jt_sim_packed(arr[i], arr[i + 1 :])
        matrix[i, i + 1 :] = row
        matrix[i + 1 :, i] = row
    return matrix


def estimate_jt_std(
    fps: NDArray[np.uint8],
    n_samples: int | None = None,
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> float:
    r"""Estimate the std of pairwise Tanimoto sims over a deterministic sample."""
    num_fps = len(fps)
    if n_samples is None:
        n_samples = max(num_fps // 1000, 50)
    sample_idxs = jt_stratified_sampling(fps, n_samples, input_is_packed, n_features)
    sample = fps[sample_idxs]
    m = len(sample)
    pairs = np.empty(m * (m - 1) // 2, dtype=np.float64)
    offset = 0
    for i in range(m):
        num = m - i - 1
        pairs[offset : offset + num] = jt_sim_packed(sample[i], sample[i + 1 :])
        offset += num
    return float(np.std(pairs))


def jt_stratified_sampling(
    fps: NDArray[np.uint8],
    n_samples: int,
    input_is_packed: bool = True,
    n_features: int | None = None,
) -> NDArray[np.int64]:
    r"""Deterministic representative sample via complementary-similarity strata.

    Sorts fingerprints by complementary iSIM, splits the order into
    ``n_samples`` contiguous strata, and takes the first index of each.
    """
    if n_samples == 0:
        return np.array([], dtype=np.int64)
    if n_samples > len(fps):
        raise ValueError("n_samples must be <= len(fps)")
    order = np.argsort(jt_compl_isim(fps, input_is_packed, n_features))
    strata = np.array_split(order, n_samples)
    return np.array([s[0] for s in strata])
