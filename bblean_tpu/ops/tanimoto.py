r"""Device-side Tanimoto similarity.

Two regimes:

1. **Search (array vs array) — matmul.**  For binary vectors,
   ``|x & y| = <x, y>``, so the full (N, C) intersection matrix of N query
   fps against C centroids is ONE matmul of the unpacked 0/1 planes.  This is
   the structural rewrite of the reference's per-row C++ popcount loop
   (``bblean/csrc/similarity.cpp:304-379``): where the CPU does N*C*B byte
   ANDs + popcounts, the device runs the same arithmetic as one matrix
   product on its matrix units.  The operands are bf16 planes (0/1 values
   are exact in bf16; products accumulate in f32, exact up to 2^24 — far
   above any fingerprint width).

2. **Packed array-vs-vector — popcount.**  For a single probe (exact-engine
   style descents or host-parity checks), AND + population_count over bytes
   widened to int32.

Denominator semantics follow the host kernels: union clamped to >= 1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array, lax

from bblean_tpu.ops.popcount import popcount_device

__all__ = ["tanimoto_matmul", "intersection_matmul", "tanimoto_packed_arr_vec"]


def intersection_matmul(queries: Array, centroids: Array) -> Array:
    r"""(N, F) x (C, F) 0/1 planes -> (N, C) int32 intersection counts.

    bf16 operands with f32 accumulation (exact for counts < 2^24).
    """
    q = queries.astype(jnp.bfloat16)
    c = centroids.astype(jnp.bfloat16)
    inter = lax.dot_general(
        q,
        c,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return inter.astype(jnp.int32)


def tanimoto_matmul(
    queries: Array,
    centroids: Array,
    query_pops: Array | None = None,
    centroid_pops: Array | None = None,
) -> Array:
    r"""Full Tanimoto similarity matrix of unpacked 0/1 fps vs centroids.

    ``sim[i, j] = |q_i & c_j| / max(|q_i| + |c_j| - |q_i & c_j|, 1)`` in f32.
    Popcounts may be passed in to amortize across calls.
    """
    inter = intersection_matmul(queries, centroids)
    if query_pops is None:
        query_pops = jnp.sum(queries.astype(jnp.int32), axis=-1)
    if centroid_pops is None:
        centroid_pops = jnp.sum(centroids.astype(jnp.int32), axis=-1)
    union = query_pops[:, None] + centroid_pops[None, :] - inter
    return inter.astype(jnp.float32) / jnp.maximum(union, 1).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=())
def tanimoto_packed_arr_vec(x: Array, y: Array) -> Array:
    r"""Tanimoto of packed (N, B) rows vs one packed (B,) vector (popcount)."""
    inter = popcount_device(jnp.bitwise_and(x, y[None, :]))
    union = popcount_device(x) + popcount_device(y) - inter
    return inter.astype(jnp.float32) / jnp.maximum(union, 1).astype(jnp.float32)
