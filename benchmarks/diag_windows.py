r"""Diagnostic: per-window wall time + rounds-per-batch for a 1M fit.

Times every fused scan window SYNCHRONOUSLY (block_until_ready between
dispatches — disables depth-2 pipelining, so totals run slower than
bench.py; the per-window numbers show WHERE time goes, not the headline).

    python benchmarks/diag_windows.py [threshold] [n_rows]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    threshold = float(sys.argv[1]) if len(sys.argv) > 1 else 0.65
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000

    import jax

    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    from bblean_tpu.engine.batch import BatchTree, _scan_fit_packed
    from bblean_tpu.fingerprints import make_fake_fingerprints

    fps = make_fake_fingerprints(n, seed=12620509540149709235)
    cap = 1 << 21 if threshold >= 0.5 else 1 << 20
    ls_cap = (1 << 17) if threshold >= 0.5 else (1 << 19)

    def build():
        return BatchTree(
            2048, threshold=threshold, batch_size=8192,
            initial_capacity=cap, ls_capacity=ls_cap,
        )

    warm = build()
    warm.fit_packed(fps[: 1 << 17], range(1 << 17))
    del warm

    tree = build()
    m, k = tree.batch_size, tree.scan_batches
    window = m * k
    dev = jax.device_put(fps[: (n // window) * window])
    jax.block_until_ready(dev)

    t_total = 0.0
    win_times = []
    all_rounds = []
    n_windows = len(dev) // window
    for w in range(n_windows):
        tree._ensure_capacity(
            window,
            g_incoming=2 * k * (tree.split_k + 4 * (m // tree.tile + 4)),
            p_incoming=window,
        )
        t0 = time.perf_counter()
        tree.state, assigned, encs = _scan_fit_packed(
            tree.state, dev, jnp.int32(w * window), jnp.int32(window),
            jnp.float32(tree.threshold), jnp.float32(tree.tolerance),
            k=k, m=m, n_features=tree.n_features,
            criterion=tree.merge_criterion, block=tree.route_block,
            max_rounds=tree.max_rounds,
            narrow=m // 4, split_k=tree.split_k, fanout=tree.fanout,
        )
        encs_np = np.asarray(encs)  # sync
        dt = time.perf_counter() - t0
        t_total += dt
        win_times.append(dt)
        all_rounds.append(encs_np % 1000)
        tree._num_upper += window
        tree._ls_upper += window
        tree._g_upper += k * tree.split_k + max(16, 4 * (window // tree.tile + 1))
        pend = encs_np // 1000
        if w % 3 == 0 or pend.any():
            print(
                f"w{w:3d}: {dt * 1e3:7.1f} ms  rounds={list(encs_np % 1000)}"
                + (f"  PEND={list(pend)}" if pend.any() else "")
            )

    rounds = np.concatenate(all_rounds)
    print(
        f"\nwindows={n_windows} total={t_total:.2f}s "
        f"mean={np.mean(win_times) * 1e3:.1f}ms "
        f"p50={np.percentile(win_times, 50) * 1e3:.1f}ms "
        f"p90={np.percentile(win_times, 90) * 1e3:.1f}ms "
        f"max={np.max(win_times) * 1e3:.1f}ms"
    )
    print(
        f"rounds/batch: mean={rounds.mean():.2f} p50={np.percentile(rounds, 50):.0f} "
        f"p90={np.percentile(rounds, 90):.0f} max={rounds.max()}"
    )
    print(f"clusters={int(tree.state.num)} groups={int(tree.state.g_num)}")


if __name__ == "__main__":
    main()
