r"""bblean-tpu: BitBIRCH clustering for very large molecular libraries on JAX.

A from-scratch JAX/XLA/Pallas re-design of the BitBIRCH-Lean algorithm
(reference: mqcomplab/bblean).  O(N) clustering of binary molecular
fingerprints under the Jaccard-Tanimoto metric with iSIM cluster cohesion,
engineered for accelerators:

- Tanimoto similarity search runs as int8/bf16 matmuls
  (``bblean_tpu.ops.tanimoto``), not per-row popcount loops.
- The cluster-feature state is stored as flat device arrays
  (``bblean_tpu.engine``), inserted level-synchronously in large batches.
- Multi-device scaling uses ``jax.sharding`` meshes with all-gather CF
  exchange between devices (``bblean_tpu.parallel``) instead of file-based
  multiprocessing.
- A bit-exact serial-equivalent engine (``bblean_tpu.engine.exact``) preserves
  reference semantics for conformance (same cluster labels), with a native C++
  fast path for host-side runs.

Public surface mirrors the reference package (``BitBirch``, ``similarity``,
``fingerprints``, ``multiround``, sklearn adapter and the ``bb`` CLI) so
existing users can switch directly.
"""

from bblean_tpu.tree import BitBirch, set_merge

__version__ = "0.1.0"

__all__ = ["BitBirch", "set_merge", "__version__"]
