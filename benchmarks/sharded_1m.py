r"""Device bench line for the SPMD sharded engine.

Runs the same 1M x 2048-bit workload as ``bench.py`` through
``ShardedForest`` on every visible device (one GPU => a 1-device mesh: the
full streaming + window dispatch + merge-reduction control plane, minus
cross-device ppermute traffic) and prints wall time and throughput next to
the single-device ``BatchTree`` number for the same threshold.

On several devices the same script times the full reduction.

    python benchmarks/sharded_1m.py [n_millions] [threshold]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path as _P

sys.path.insert(0, str(_P(__file__).resolve().parent.parent))
import time

import numpy as np


def main() -> None:
    n_millions = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    threshold = float(sys.argv[2]) if len(sys.argv) > 2 else 0.30
    n = int(n_millions * 1_000_000)

    import jax

    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()

    from bblean_tpu.fingerprints import make_fake_fingerprints
    from bblean_tpu.parallel import ShardedForest, get_mesh

    fps = make_fake_fingerprints(n, seed=12620509540149709235)
    mesh = get_mesh()
    d = int(mesh.devices.size)

    # Stage the input in HBM before timing (the same methodology as
    # bench.py's BatchTree primary and the reference's RAM-resident CI
    # bench); the fit slices it at a traced offset inside the scan.
    # Pass --stream to time the host-streamed path instead.
    if "--stream" not in sys.argv:
        fps = jax.device_put(fps)
        jax.block_until_ready(fps)

    def build() -> ShardedForest:
        return ShardedForest(
            2048,
            mesh,
            threshold=threshold,
            batch_size=8192,
            initial_capacity=1 << 19,
            ls_capacity=1 << 18,
        )

    # Warm-up: compiles + first-executes the window/split/merge programs.
    # Uses the FULL input so the resident window-major buffer (and the
    # jit programs specialized on its shape) match the timed run exactly.
    warm = build()
    warm.fit_packed(fps)
    warm.merge()
    _ = warm.num_clusters
    del warm

    forest = build()
    # Mass-less warm on the TIMED forest: per-forest HBM allocation +
    # donation churn paid outside the timed region (programs themselves are
    # shared across forests via the module-level cache)
    forest.warm_programs(fps)
    t0 = time.perf_counter()
    forest.fit_packed(fps)
    fit_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    forest.merge()
    num = forest.num_clusters  # device sync
    merge_s = time.perf_counter() - t1
    wall = fit_s + merge_s

    print(
        json.dumps(
            {
                "metric": (
                    f"sharded_fps_per_sec_{n // 1000}k_t{threshold}_"
                    f"{d}dev"
                ),
                "value": round(n / wall, 1),
                "unit": "fingerprints/s",
                "wall_s": round(wall, 2),
                "fit_s": round(fit_s, 2),
                "merge_s": round(merge_s, 2),
                "n_clusters": int(num),
                "n_devices": d,
                "state_bytes_per_device_gib": round(
                    forest.state_bytes_per_device() / 2**30, 2
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
