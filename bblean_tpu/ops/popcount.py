r"""Device-side popcount over packed fingerprint rows.

Packed uint8 bytes are widened to int32 and counted with
``lax.population_count``, one byte per 32-bit element; XLA fuses the
widening, AND and popcount with the surrounding gather and reduction.  The
form is shape-agnostic (any byte count).  Counting 32- or 64-bit words
instead would take 4-8x fewer popcounts; whether that pays on the GPU is
open work (ROADMAP Queue 1).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array, lax

__all__ = ["popcount_device", "popcount_rows"]


def popcount_device(packed: Array) -> Array:
    r"""Per-row popcount of a packed (..., B) uint8 array -> (...,) int32."""
    words = packed.astype(jnp.int32)
    return jnp.sum(lax.population_count(words), axis=-1)


def popcount_rows(unpacked: Array) -> Array:
    r"""Per-row popcount of an unpacked (..., F) 0/1 array -> (...,) int32."""
    return jnp.sum(unpacked.astype(jnp.int32), axis=-1)
