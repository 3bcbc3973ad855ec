r"""Device-side fingerprint bit packing / unpacking.

XLA has no ``np.packbits`` equivalent; packing is expressed as elementwise
arithmetic that XLA fuses:

- unpack: broadcast each byte against the 8 bit positions and mask
  (big-endian bit order, matching ``np.unpackbits``).
- pack: dot the 0/1 bit planes with the per-position powers of two
  (matching ``np.packbits``).

These are jit-friendly (static shapes) and used at the batch-engine edges;
inside the engine the matmuls run in the unpacked int8 domain.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["unpack_fingerprints_device", "pack_fingerprints_device"]

# np.packbits / np.unpackbits use big-endian bit order within each byte.
# Kept as NumPy constants: device-array module constants would force a host
# fetch every time they are embedded into a lowered program.
_BIT_SHIFTS = np.arange(7, -1, -1, dtype=np.uint8)  # (8,)
_BIT_WEIGHTS = (1 << np.arange(7, -1, -1)).astype(np.int32)


def unpack_fingerprints_device(
    packed: Array, n_features: int | None = None
) -> Array:
    r"""Unpack a (..., B) uint8 array to (..., B*8) 0/1 uint8 bits.

    ``n_features`` trims the trailing pad bits.
    """
    packed = packed.astype(jnp.uint8)
    bits = (packed[..., :, None] >> _BIT_SHIFTS) & jnp.uint8(1)
    out = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    if n_features is not None:
        out = out[..., :n_features]
    return out


def pack_fingerprints_device(bits: Array) -> Array:
    r"""Pack a (..., F) 0/1 array into (..., ceil(F/8)) uint8 bytes."""
    f = bits.shape[-1]
    pad = (-f) % 8
    if pad:
        bits = jnp.pad(
            bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)], constant_values=0
        )
    grouped = bits.reshape(*bits.shape[:-1], -1, 8).astype(jnp.int32)
    packed = jnp.sum(grouped * _BIT_WEIGHTS, axis=-1)
    return packed.astype(jnp.uint8)
