r"""Clustering engines.

- ``bblean_tpu.engine.exact`` — bit-exact serial-equivalent BitBirch tree
  (host side, flat id-indexed pools, iterative insert; conformance oracle and
  default for label-compatible runs).
- ``bblean_tpu.engine.batch`` — level-synchronous batched device engine
  (matmul similarity search over cluster-feature arrays; the performance
  path); ``bblean_tpu.engine.run`` drives it (and the sharded engine) over
  ``.npy`` files for ``bb run``.
"""

from bblean_tpu.engine.exact import ExactTree

__all__ = ["ExactTree"]
