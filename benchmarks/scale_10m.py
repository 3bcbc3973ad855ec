"""Scale validation: 10M x 2048-bit fingerprints on one device.

Times a warmed fit (``warm_programs`` first, so compile and first-window
allocator churn are excluded — the timing covers every host bookkeeping
and boundary-sync cost of the steady engine), then mol extraction, and
checks the device-memory peak.  Earlier runs of this seed gave 3,977,532
clusters at t=0.3 and 9,783,327 at t=0.65 (cluster counts do not depend on
the device's speed); no GPU time has been recorded yet.

Usage: python benchmarks/scale_10m.py [n_millions] [threshold] [streamed]

Pass ``streamed`` as the third argument to force the host-streamed input
path even when the input would fit the device — this measures the configuration
that carries inputs past ~12M rows (the reference's 100M+ design scale).

Fingerprints stream from host batch-by-batch (one-ahead overlap), so the
input array never needs to be resident; with `threshold >= 0.5` the sparse
linear-sum pool keeps per-cluster memory at F/8 bytes for singletons (see
docs/device-memory.md).
"""

import sys
from pathlib import Path as _P

sys.path.insert(0, str(_P(__file__).resolve().parent.parent))
import time

import numpy as np

import jax

from pathlib import Path

from bblean_tpu._jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from bblean_tpu.engine.batch import BatchTree
from bblean_tpu.fingerprints import make_fake_fingerprints

SEED = 12620509540149709235


def main() -> None:
    n_m = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    threshold = float(sys.argv[2]) if len(sys.argv) > 2 else 0.65
    force_streamed = "streamed" in sys.argv[3:]
    n = n_m * 1_000_000

    t0 = time.perf_counter()
    cache = Path(__file__).resolve().parent.parent / ".scratch" / f"fps{n_m}m.npy"
    if cache.exists():
        fps = np.load(cache, mmap_mode="r")
        print(f"gen: cached ({cache}) {fps.nbytes / 1e9:.2f} GB")
    else:
        fps = make_fake_fingerprints(n, seed=SEED)
        cache.parent.mkdir(exist_ok=True)
        np.save(cache, fps)
        print(f"gen: {time.perf_counter() - t0:.0f}s {fps.nbytes / 1e9:.2f} GB")

    kw = dict(
        threshold=threshold,
        batch_size=8192,
        fanout=384,
        tile=512,
        g_capacity=1 << 16 if threshold >= 0.5 else 1 << 15,
        initial_capacity=1 << 24 if threshold >= 0.5 else 1 << 23,
        # Both regimes keep the sparse pool tiny: 2.6k rows at t=0.65
        # (singletons), 17k at t=0.3 (few giant clusters + singletons)
        ls_capacity=1 << 16,
    )
    # Keep the input device-resident whenever it fits next to the tables:
    # on-device slicing beats the streamed host-upload path by ~40% at
    # t=0.65 (109.6k vs 65.6k fps/s at 10M) — NOT because of transfer
    # bandwidth (a bulk device_put moves 2.56 GB in 3.5 s here) but because
    # the per-window staging (pad + contiguous copy + upload) serializes
    # against the scan dispatches.  At 10M the t=0.65 tables (~10 GiB) +
    # 2.56 GiB of input still fit a 16 GiB chip; past ~12M rows the input
    # streams (the 20M line below).
    if not force_streamed and (threshold < 0.5 or fps.nbytes <= 3.0e9):
        fps = jax.device_put(np.asarray(fps))
        jax.block_until_ready(fps)
    elif force_streamed:
        print("input: host-streamed (forced)")

    # Warm-up: compile every program at the final table shapes, including
    # the rare retry/flush programs (warm_programs), so a first-execution
    # mid-timed-run never bills program-load cost to the engine.  jit
    # specializes _slice_prep_fp_rows/_scan_fit_packed on the INPUT BUFFER
    # shape: the host-streamed run (t>=0.5) feeds window-sized staging
    # buffers (scan_batches * batch_size rows), while the device-resident
    # run (t<0.5) slices the full fps array directly — so the timed tree
    # must be warmed with a buffer of exactly the shape the timed run uses.
    warm = BatchTree(2048, **kw)
    window = warm.scan_batches * warm.batch_size
    if isinstance(fps, jax.Array):
        warm_rows = fps  # timed run slices the resident array itself
        small = fps[: 1 << 16]  # device slice; no host round-trip
    else:
        # Streamed fits stage chunks of stage_windows windows; warm at
        # exactly that buffer shape (jit specializes on it)
        n_w = -(-len(fps) // window)
        chunk_rows = (1 if n_w <= 1 else warm.stage_windows) * window
        warm_rows = jax.device_put(np.ascontiguousarray(fps[:chunk_rows]))
        small = warm_rows[: 1 << 16]
    warm.fit_packed(small, range(1 << 16))
    warm.warm_programs(warm_rows)
    jax.block_until_ready(warm.state.n)
    del warm, small

    tree = BatchTree(2048, **kw)
    tree.warm_programs(warm_rows)
    del warm_rows
    t0 = time.perf_counter()
    tree.fit_packed(fps, range(n))
    num = tree.num_clusters
    dt = time.perf_counter() - t0
    print(
        f"fit: {dt:.1f}s = {n / dt:,.0f} fps/s  clusters={num:,} "
        f"groups={tree.num_groups:,}  ls_pool={int(tree.state.num_ls):,}"
    )
    # Release the resident input before extraction: the fit no longer needs
    # it, and 2.56 GB next to near-full tables makes extraction's device
    # passes allocate under pressure (measured 62 s vs 25 s at 10M t=0.65)
    del fps
    t0 = time.perf_counter()
    sizes = tree.cluster_sizes()
    mols = tree.cluster_mols()
    assert sizes.sum() == n and sum(len(m) for m in mols) == n
    print(f"extraction: {time.perf_counter() - t0:.1f}s")

    from bblean_tpu._memory import device_memory_stats

    hbm = device_memory_stats() or {}
    peak = hbm.get("peak_bytes_in_use")
    if peak is not None:
        print(f"device memory peak: {peak / 2**30:.2f} GiB")
        # Machine-check of the docs/device-memory.md arithmetic: the 10M
        # configs hold ~10 GiB of tables at t=0.65 (tiles ~8.6 GiB) and
        # ~5 GiB + 2.6 GiB staged input at t=0.3
        budget_gib = 14.0
        if n_m <= 10 and peak / 2**30 > budget_gib:
            raise SystemExit(
                f"device memory regression: peak {peak / 2**30:.2f} GiB exceeds the "
                f"{budget_gib} GiB budget for the {n_m}M config"
            )


if __name__ == "__main__":
    main()
