r"""JAX/XLA device ops — the accelerator compute path.

Design: the reference's hot kernels (C++ popcount/Tanimoto loops,
``bblean/csrc/similarity.cpp``) become whole-array XLA programs instead:

- Similarity *search* (many fps vs many centroids) is a matmul over
  unpacked 0/1 int8/bf16 planes: ``|x & y| == <x, y>`` for binary vectors
  (``bblean_tpu.ops.tanimoto``), which XLA hands to the matrix units.
- Packed-domain reductions (popcount, AND+popcount for a few vectors) are
  ``lax.population_count`` over bytes widened to int32
  (``bblean_tpu.ops.popcount``), fused by XLA with the gather and AND.
- iSIM / merge-criteria evaluation is batched elementwise arithmetic over
  candidate linear sums (``bblean_tpu.ops.isim``, ``bblean_tpu.ops.merges``).
- Bit pack/unpack is shift/compare arithmetic (``bblean_tpu.ops.packing``).
"""

from bblean_tpu.ops.packing import pack_fingerprints_device, unpack_fingerprints_device
from bblean_tpu.ops.popcount import popcount_device, popcount_rows
from bblean_tpu.ops.tanimoto import (
    tanimoto_matmul,
    tanimoto_packed_arr_vec,
)
from bblean_tpu.ops.isim import (
    isim_from_sums,
    isim_radius_compl_from_sums,
)

__all__ = [
    "pack_fingerprints_device",
    "unpack_fingerprints_device",
    "popcount_device",
    "popcount_rows",
    "tanimoto_matmul",
    "tanimoto_packed_arr_vec",
    "isim_from_sums",
    "isim_radius_compl_from_sums",
]
