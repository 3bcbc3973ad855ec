r"""Microbenchmark of the two per-step search kernels the engine runs.

1. The group route (``engine/batch.py::_route_groups``): argmax Tanimoto of
   M rows over the live group centroids, a tiled matmul paid once per batch
   step.  Timed with the engine's centroid dtype (``_CENT_DT``) beside the
   other exact choice (int8 with int32 accumulation vs bf16 with f32
   accumulation; both exact for 0/1 values), and the optimized HLO is
   searched for the library call or fusion each dot became.
2. The in-group tile search (``_search_tiles``: gather + AND + popcount +
   argmax) as a standalone dispatch at the ``predict_packed`` shape.
3. Both inside the fit: a profiler trace of fused scan windows on a fitted
   state, reduced to device time per ``jax.named_scope``
   (``benchmarks/parse_trace.py``).

Every line names the card (``nvidia-smi`` name and power limit).  Needs a
GPU; ``--small`` shrinks every shape so the script runs anywhere.

    python benchmarks/route_cost.py [--small]
"""

from __future__ import annotations

import argparse
import collections
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bblean_tpu._jax_cache import enable_persistent_cache  # noqa: E402

F = 2048


def _median_ms(fn, *args, reps: int = 20, **kw) -> float:
    jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _gemm_kinds(hlo_text: str) -> list[str]:
    r"""Library calls (cuBLAS/cuBLASLt/cuDNN custom calls) and fusion
    emitters (e.g. ``__triton_gemm``) in an optimized GPU program, plus the
    dots XLA left to its own emitters."""
    kinds = set(re.findall(r'custom_call_target="([^"]+)"', hlo_text))
    kinds |= {f"fusion:{k}" for k in re.findall(r'"kind":"([^"]+)"', hlo_text)}
    for line in hlo_text.splitlines():
        if " dot(" in line:
            kinds.add("dot:" + line.split("=")[1].split("(")[0].strip()[:60])
    return sorted(kinds)


def route_table(card, m, g_cap, lives, block):
    from bblean_tpu.engine.batch import _CENT_DT, _route_groups

    rng = np.random.default_rng(0)
    rows = rng.random((m, F)) < 0.35
    cents = rng.random((g_cap, F)) < 0.35
    row_pop = jnp.asarray(rows.sum(1), jnp.int32)
    g_pops = jnp.asarray(cents.sum(1), jnp.int32)
    pending = jnp.ones((m,), bool)
    route = jax.jit(_route_groups, static_argnames=("block",))
    other = jnp.bfloat16 if _CENT_DT == jnp.int8 else jnp.int8
    results = {}
    for dt in (_CENT_DT, other):
        r = jnp.asarray(rows, dtype=dt)
        c = jnp.asarray(cents, dtype=dt)
        args = (r, row_pop, c, g_pops, jnp.int32(lives[0]), pending)
        hlo = route.lower(*args, block=block).compile().as_text()
        print(f"[{card}] route {jnp.dtype(dt).name} lowering: "
              f"{_gemm_kinds(hlo)}", flush=True)
        outs = []
        for g_live in lives:
            args = (r, row_pop, c, g_pops, jnp.int32(g_live), pending)
            ms = _median_ms(route, *args, block=block)
            tops = 2.0 * m * g_live * F / (ms * 1e-3) / 1e12
            outs.append(np.asarray(route(*args, block=block)))
            print(f"[{card}] route {jnp.dtype(dt).name}: m={m} f={F} "
                  f"block={block} live_groups={g_live} ms={ms:.4f} "
                  f"tera_ops_per_s={tops:.2f}", flush=True)
            results[(jnp.dtype(dt).name, g_live)] = ms
        results[jnp.dtype(dt).name] = outs
    same = all(
        np.array_equal(a, b)
        for a, b in zip(results["int8"], results["bfloat16"])
    )
    print(f"[{card}] route int8 and bf16 argmax identical: {same}")
    return results


def search_standalone(card, m, n_groups, fc):
    from bblean_tpu.engine.batch import _search_tiles

    rng = np.random.default_rng(1)
    f8 = F // 8
    t_pk = rng.integers(0, 256, (n_groups, fc, f8), dtype=np.uint8)
    t_pops = np.unpackbits(t_pk, axis=-1).sum(-1).astype(np.int32)
    t_slot = np.arange(n_groups * fc, dtype=np.int32).reshape(n_groups, fc)
    row_pk = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    row_pop = np.unpackbits(row_pk, axis=-1).sum(-1).astype(np.int32)
    row_group = rng.integers(0, n_groups, m).astype(np.int32)
    args = [
        jnp.asarray(x) for x in (
            row_pk, row_pop, row_group, t_pk, t_pops, t_slot,
            np.ones(m, bool),
        )
    ]
    ms = _median_ms(jax.jit(_search_tiles), *args)
    gbytes = m * fc * f8 / 1e9
    print(f"[{card}] tile_search standalone: m={m} fc={fc} f8={f8} "
          f"groups={n_groups} ms={ms:.4f} "
          f"gathered_tile_GB_per_s={gbytes / (ms * 1e-3):.1f}", flush=True)


def in_step(card, rows, batch, threshold):
    from benchmarks.parse_trace import (
        busy_ns, device_events, latest_xplane, scope_time,
    )
    from bblean_tpu.engine.batch import BatchTree, _scan_fit_packed
    from chip_smoke import device_fingerprints

    n_win = 2
    dev_fps = device_fingerprints(rows + n_win * 16 * batch, seed=5)
    tree = BatchTree(
        F, threshold=threshold, batch_size=batch,
        initial_capacity=rows + (n_win * 16 + 1) * batch + 1,
    )
    tree.warm_programs(dev_fps)
    tree.fit_packed(dev_fps[:rows], range(rows))
    groups = tree.num_groups
    k, m = tree.scan_batches, tree.batch_size
    kw = dict(
        k=k, m=m, n_features=F, criterion=tree.merge_criterion,
        block=tree.route_block, max_rounds=tree.max_rounds, narrow=m // 4,
        split_k=tree.split_k, fanout=tree.fanout,
    )
    thr, tol = jnp.float32(threshold), jnp.float32(tree.tolerance)
    # The traced windows insert fresh rows past the fitted ones into the
    # fitted tables, as a continued fit would
    hlo = _scan_fit_packed.lower(
        tree.state, dev_fps, jnp.int32(rows), jnp.int32(k * m), thr, tol,
        **kw,
    ).compile().as_text()
    with tempfile.TemporaryDirectory() as tdir:
        jax.profiler.start_trace(tdir)
        t0 = time.perf_counter()
        for w in range(n_win):
            tree.state, assigned, _ = _scan_fit_packed(
                tree.state, dev_fps, jnp.int32(rows + w * k * m),
                jnp.int32(k * m), thr, tol, **kw,
            )
        jax.block_until_ready(assigned)
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        events = device_events(latest_xplane(tdir))
    per = scope_time(events, hlo, ("route_groups", "tile_search"))
    steps = n_win * k
    # Kernels replayed inside a CUDA-graph command buffer show up as one
    # "command_buffer" event, so their scopes cannot be attributed
    graphed = sum(e["dur_ns"] for e in events if e["op"] == "command_buffer")
    window = max(e["start_ns"] + e["dur_ns"] for e in events) - min(
        e["start_ns"] for e in events
    ) if events else 0.0
    busy = busy_ns(events)
    top = collections.Counter()
    for e in events:
        top[(e["line"], e["op"])] += e["dur_ns"]
    print(f"[{card}] in-step t={threshold} trace: device_events={len(events)} "
          f"window_ms={window / 1e6:.3f} busy_ms={busy / 1e6:.3f} "
          f"idle_share={1 - busy / window if window else float('nan'):.4f} "
          f"matched_ms={per.get('total', 0) / 1e6:.3f} "
          f"top_ops_ms={[(ln, op, round(d / 1e6, 3)) for (ln, op), d in top.most_common(12)]}",
          flush=True)
    def scope_ms(name):
        if graphed > 0.5 * busy:
            return "not_measured(command_buffer)"
        return f"{per.get(name, 0) / 1e6 / steps:.3f}"

    print(f"[{card}] in-step t={threshold}: fitted_rows={rows} "
          f"live_groups={groups} batch={m} steps={steps} "
          f"wall_ms_per_step={wall * 1e3 / steps:.3f} "
          f"device_busy_ms_per_step={busy / 1e6 / steps:.3f} "
          f"route_ms_per_step={scope_ms('route_groups')} "
          f"tile_search_ms_per_step={scope_ms('tile_search')}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    enable_persistent_cache()
    dev = jax.devices()[0]
    if args.small:
        card = f"{dev.platform} {dev.device_kind} (small shapes)"
        route_table(card, 256, 1024, (256, 512), 128)
        search_standalone(card, 256, 64, 32)
        in_step(card, 4096, 128, 0.65)
        return
    if dev.platform != "gpu":
        raise SystemExit("route_cost.py needs a GPU (or --small)")
    from chip_smoke import card_name

    card = card_name()
    route_table(card, 8192, 1 << 16, (4096, 16384, 43008), 1024)
    search_standalone(card, 8192, 16384, 256)
    for thr in (0.65, 0.3):
        in_step(card, 1 << 20, 8192, thr)


if __name__ == "__main__":
    main()
