r"""Diagnostic: 1M fit with boundary pops deferred to the end.

Isolates the host boundary-processing cost: windows dispatch back-to-back
with NO per-window sync (queue entries are set aside un-synced; the
in-step pool guard covers the un-refreshed pool bound), then one final
drain settles everything.  Compare against bench.py's depth-2 pipelined
number: the difference is what the per-window pop costs end to end.

    python benchmarks/diag_nopop.py [threshold]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    threshold = float(sys.argv[1]) if len(sys.argv) > 1 else 0.65
    n = 1_000_000

    import jax

    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()

    from bblean_tpu.engine.batch import BatchTree
    from bblean_tpu.fingerprints import make_fake_fingerprints

    fps = make_fake_fingerprints(n, seed=12620509540149709235)
    cap = 1 << 21 if threshold >= 0.5 else 1 << 19
    dev = jax.device_put(fps)
    jax.block_until_ready(dev)

    def build():
        return BatchTree(
            2048, threshold=threshold, batch_size=8192,
            initial_capacity=cap, ls_capacity=1 << 18,
        )

    warm = build()
    warm.fit_packed(dev[: 1 << 17], range(1 << 17))
    del warm

    tree = build()
    real_pop = tree._process_oldest_boundary
    deferred: list[dict] = []

    def defer_pop():
        # Set the oldest entry aside WITHOUT syncing; keep the host's pool
        # bound pessimistic so capacity growth still happens un-synced
        deferred.append(tree._boundary_queue.pop(0))
        tree._ls_upper += tree.batch_size

    tree._process_oldest_boundary = defer_pop  # type: ignore[method-assign]
    t0 = time.perf_counter()
    tree.fit_packed(dev, range(n))
    dispatch_done = time.perf_counter() - t0
    tree._process_oldest_boundary = real_pop  # type: ignore[method-assign]
    tree._boundary_queue = deferred + tree._boundary_queue
    tree.flush()
    num = tree.num_clusters
    dt = time.perf_counter() - t0
    print(
        f"nopop: {n / dt:,.0f} fps/s wall={dt:.2f}s "
        f"(dispatch phase {dispatch_done:.2f}s) clusters={num} "
        f"deferred={len(deferred)}"
    )


if __name__ == "__main__":
    main()
