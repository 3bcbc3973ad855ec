#!/usr/bin/env python3
r"""GPU smoke check: the batch and sharded engines on one card, end to end.

Runs in ONE process (a JAX process reserves most of the card's memory) and
checks the device path through the entry points users call:

- phase 1: the engine's device kernels at real widths, compiled for the
  card, against plain NumPy int64/float64 references (correctly rounded
  division, route matmul, in-group tile search, merge criteria,
  ``tanimoto_matmul``);
- phase 2: ``BatchTree`` at 20k rows (t=0.65 and t=0.3): mass, cohesion,
  cluster count against the native exact engine, run-to-run determinism on
  the card, and the same fit on the CPU backend;
- phase 3: 1M rows at F=2048: ``BatchTree.fit_packed`` on resident input at
  t=0.65 and t=0.3, ``ShardedForest`` on a 1-device mesh at t=0.3, and the
  ``bb run --engine batch`` device path (host-streamed input, mol lists,
  ``clusters.pkl``).  Times here are findings, printed with the card.

``--four-cards`` runs only the sharded path: ``ShardedForest`` over a
4-GPU mesh at 1M rows per card, beside the 1-card forest on the same rows.

Every line that carries a number names the card and its power limit.  The
last line of stdout is ``{"ok": true, "device": {...}}``; without a GPU, or
when any check fails, the script exits non-zero and prints no such line.

Usage::

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 12620509540149709235
F = 2048
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


class CheckFailed(AssertionError):
    r"""A smoke check that did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


class Report:
    r"""Prints result lines prefixed with the card they were measured on."""

    def __init__(self, card: str) -> None:
        self.card = card

    def line(self, what: str, **nums) -> None:
        vals = " ".join(f"{k}={v}" for k, v in nums.items())
        print(f"[{self.card}] {what}: {vals}", flush=True)


def card_name() -> str:
    r"""``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def require_gpu(devices, count: int = 1) -> None:
    r"""Exit non-zero unless JAX's first device is a GPU (and ``count`` of
    them are visible)."""
    if devices[0].platform != "gpu" or len(devices) < count:
        print(
            f"chip_smoke: needs {count} GPU(s); JAX sees "
            f"{len(devices)} {devices[0].platform} device(s)",
            file=sys.stderr,
        )
        raise SystemExit(2)


def device_fingerprints(n: int, seed: int, chunk: int = 1 << 15):
    r"""(n, F/8) packed fingerprints generated on the default device.

    Same law as ``make_fake_fingerprints`` (popcounts from a normal with
    loc 750 and scale 400 truncated to [1, F-1], bits at uniformly random
    positions), drawn with ``jax.random`` so a million rows cost no host
    time.  Not bit-identical to the host generator.
    """
    import jax
    import jax.numpy as jnp

    from bblean_tpu.ops.packing import pack_fingerprints_device

    chunk = min(chunk, n)
    lo, hi = (1 - 750) / 400, (F - 1 - 750) / 400

    @jax.jit
    def gen(key):
        k_pop, k_pos = jax.random.split(key)
        pops = jnp.rint(
            750 + 400 * jax.random.truncated_normal(k_pop, lo, hi, (chunk,))
        ).astype(jnp.int32)
        keys = jax.random.uniform(k_pos, (chunk, F))
        kth = jnp.take_along_axis(
            jnp.sort(keys, axis=1), (pops - 1)[:, None], axis=1
        )
        return pack_fingerprints_device((keys <= kth).astype(jnp.uint8))

    base = jax.random.PRNGKey(seed % (1 << 31))
    parts = [
        gen(jax.random.fold_in(base, i)) for i in range(-(-n // chunk))
    ]
    return jnp.concatenate(parts)[:n]


def _unpack(packed: np.ndarray) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)


def _host_isim(ls: np.ndarray, n: np.ndarray) -> np.ndarray:
    r"""float64 iSIM of each (linear sum, count) row."""
    ls = ls.astype(np.float64)
    k = ls.sum(1)
    ksq = (ls * ls).sum(1)
    a = (ksq - k) / 2
    with np.errstate(invalid="ignore", divide="ignore"):
        isim = a / (a + n * k - ksq)
    return np.where(k == 0, 1.0, isim)


def _multi_member_sums(state, stacked: bool = False):
    r"""Host (linear sum, count) of every live multi-member cluster, read
    from the sparse pool (singletons hold no pool row and need no check)."""
    pick = (lambda x: np.asarray(x[0])) if stacked else np.asarray
    num = int(pick(state.num))
    n = pick(state.n)[:num]
    ref = pick(state.ls_ref)[:num]
    multi = (n >= 2) & (ref >= 0)
    pool = pick(state.ls)
    return pool[ref[multi]].astype(np.int64), n[multi]


def _check_cohesion(ls: np.ndarray, n: np.ndarray, threshold: float, what):
    if not len(n):
        return 1.0
    isim = _host_isim(ls, n)
    worst = float(isim.min())
    check(
        worst >= threshold - 1e-5,
        f"{what}: cluster iSIM {worst} < threshold {threshold} - 1e-5",
    )
    return worst


# -- phase 1: kernels ---------------------------------------------------------


def _route_case(rng, m, g_live, g_cap):
    g_bits = (rng.random((g_cap, F)) < 0.35).astype(np.uint8)
    base = rng.integers(0, g_live, m)
    flip = rng.random((m, F)) < 0.1
    rows = np.where(flip, 1 - g_bits[base], g_bits[base]).astype(np.uint8)
    pending = rng.random(m) < 0.9
    return rows, g_bits, pending


def check_route(rep, rng, m, g_live, g_cap, block):
    import jax
    import jax.numpy as jnp

    from bblean_tpu.engine.batch import _CENT_DT, _intersections, _route_groups

    rows, g_bits, pending = _route_case(rng, m, g_live, g_cap)
    row_pop = rows.sum(1).astype(np.int32)
    g_pop = g_bits.sum(1).astype(np.int32)
    d_rows = jnp.asarray(rows, dtype=_CENT_DT)
    d_g = jnp.asarray(g_bits, dtype=_CENT_DT)
    route = jax.jit(_route_groups, static_argnames=("block",))
    best = np.asarray(
        route(
            d_rows, jnp.asarray(row_pop), d_g, jnp.asarray(g_pop),
            jnp.int32(g_live), jnp.asarray(pending), block=block,
        )
    )
    inter = np.asarray(jax.jit(_intersections)(d_rows, d_g[:g_live]))
    ref = rows.astype(np.float64) @ g_bits[:g_live].T.astype(np.float64)
    check(np.array_equal(inter, ref), "route intersections differ")
    union = np.maximum(row_pop[:, None] + g_pop[None, :g_live] - ref, 1)
    sims = ref / union
    top2 = -np.partition(-sims, 1, axis=1)[:, :2]
    clear = pending & (top2[:, 0] - top2[:, 1] > 1e-6)
    ref_best = sims.argmax(1)
    check(
        np.array_equal(best[clear], ref_best[clear]),
        "route argmax differs where the top two differ by > 1e-6",
    )
    got = sims[np.flatnonzero(pending), best[pending]]
    check(
        bool((got >= top2[pending, 0] - 1e-6).all()),
        "route picked a group below the best",
    )
    check(bool((best[~pending] == 0).all()), "route output for idle rows")
    rep.line(
        "phase1 route", m=m, f=F, live_groups=g_live, block=block,
        dtype=np.dtype(_CENT_DT).name, clear_rows=int(clear.sum()),
        ok=True,
    )
    return rows, g_bits


def _search_case(rng, m, n_groups, fc, f8):
    g_cap = n_groups + 1  # last group is the engine's scatter guard
    t_pk = rng.integers(0, 256, (g_cap, fc, f8), dtype=np.uint8)
    t_pk &= rng.integers(0, 256, (g_cap, fc, f8), dtype=np.uint8)
    fill = rng.integers(0, fc + 1, g_cap)
    fill[: n_groups // 4] = fc  # merge-heavy: full tiles
    fill[-1] = 0
    occ = np.arange(fc)[None, :] < fill[:, None]
    t_slot = np.where(occ, np.arange(g_cap * fc).reshape(g_cap, fc), -1)
    t_pk[~occ] = 0
    t_pops = _POP8[t_pk].sum(-1).astype(np.int32)
    # Half the rows crowd four hot groups (merge-heavy), half spread out
    hot = rng.integers(0, 4, m // 2)
    spread = rng.integers(0, n_groups, m - m // 2)
    row_group = np.concatenate([hot, spread]).astype(np.int32)
    rng.shuffle(row_group)
    src = t_pk[row_group, rng.integers(0, fc, m)]
    noise = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    row_pk = np.where(rng.random((m, f8)) < 0.2, noise, src).astype(np.uint8)
    row_pop = _POP8[row_pk].sum(-1).astype(np.int32)
    pending = rng.random(m) < 0.9
    return row_pk, row_pop, row_group, t_pk, t_pops, t_slot.astype(
        np.int32
    ), pending


def search_reference(row_pk, row_pop, row_group, t_pk, t_pops, t_slot,
                     pending, chunk: int = 512):
    r"""NumPy int64 intersections and float64 similarities of every row
    against its routed tile (-2 for empty cells and idle rows)."""
    m = len(row_pk)
    inter = np.empty((m, t_pk.shape[1]), np.int64)
    for a in range(0, m, chunk):
        b = min(a + chunk, m)
        tiles = t_pk[row_group[a:b]]
        inter[a:b] = _POP8[tiles & row_pk[a:b, None, :]].sum(-1)
    union = np.maximum(t_pops[row_group] + row_pop[:, None] - inter, 1)
    sims = inter / union
    live = (t_slot[row_group] >= 0) & pending[:, None]
    return inter, np.where(live, sims, -2.0)


def check_search(rep, rng, m, n_groups, fc, f8):
    import jax
    import jax.numpy as jnp

    from bblean_tpu.engine.batch import _search_tiles, _tile_intersections

    case = _search_case(rng, m, n_groups, fc, f8)
    row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = case
    dev = [jnp.asarray(x) for x in case]
    inter = np.asarray(
        jax.jit(_tile_intersections)(dev[0], dev[2], dev[3])
    )
    best_sim, best_slot = (
        np.asarray(x) for x in jax.jit(_search_tiles)(*dev)
    )
    ref_inter, ref_sims = search_reference(*case)
    check(np.array_equal(inter, ref_inter), "tile intersections differ")
    ref_best = ref_sims.max(1)
    check(
        bool(np.abs(best_sim - ref_best).max() <= 1e-6),
        "tile-search similarity differs by more than 1e-6",
    )
    top2 = -np.partition(-ref_sims, 1, axis=1)[:, :2]
    clear = (ref_best > -1.5) & (top2[:, 0] - top2[:, 1] > 1e-6)
    ref_slot = t_slot[row_group, ref_sims.argmax(1)]
    check(
        np.array_equal(best_slot[clear], ref_slot[clear]),
        "tile-search slot differs where the top two differ by > 1e-6",
    )
    rep.line(
        "phase1 tile_search", m=m, fc=fc, f8=f8, groups=n_groups,
        clear_rows=int(clear.sum()), ok=True,
    )


def check_merges(rep, rng, n_cand=2048, max_members=16):
    import jax.numpy as jnp

    from bblean_tpu._merges import get_merge_accept_fn
    from bblean_tpu.ops.merges import merge_accept_batch

    # Clusters of prototype + noisy members (a per-cluster share of bits
    # redrawn) whose cohesion spans both thresholds; the nominee is one
    # more member
    protos = rng.random((n_cand, F)) < 0.35
    redraw_p = rng.uniform(0.0, 1.0, n_cand)[:, None]

    def member():
        fresh = rng.random((n_cand, F)) < 0.35
        redraw = rng.random((n_cand, F)) < redraw_p
        return np.where(redraw, fresh, protos).astype(np.int64)

    old_n = rng.integers(1, max_members + 1, n_cand)
    old_ls = np.zeros((n_cand, F), np.int64)
    for j in range(max_members):
        old_ls += np.where((j < old_n)[:, None], member(), 0)
    nom = member()
    new_ls, new_n = old_ls + nom, old_n + 1
    nom_n = np.ones(n_cand, np.int64)
    tol = 0.05
    flips = 0
    for criterion in ("diameter", "radius", "tolerance-diameter"):
        for thr in (0.3, 0.65):
            dev = np.asarray(
                merge_accept_batch(
                    criterion, jnp.float32(thr),
                    jnp.asarray(new_ls, jnp.int32), jnp.asarray(new_n, jnp.int32),
                    jnp.asarray(old_ls, jnp.int32), jnp.asarray(old_n, jnp.int32),
                    jnp.asarray(nom_n, jnp.int32), tolerance=tol,
                )
            )
            fn = get_merge_accept_fn(criterion, tol)
            host = np.array([
                bool(fn(
                    thr, new_ls[i].astype(np.uint64), int(new_n[i]),
                    old_ls[i].astype(np.uint64), nom[i].astype(np.uint64),
                    int(old_n[i]), 1,
                ))
                for i in range(n_cand)
            ])
            # Decisions may differ only within 1e-5 of a compared bound
            # (the f32 iSIM contract of ops/isim.py)
            if criterion == "radius":
                from bblean_tpu.similarity import (
                    jt_isim_radius_compl_from_sum as coh,
                )

                new_c = np.array([
                    coh(new_ls[i].astype(np.uint64), int(new_n[i]))
                    for i in range(n_cand)
                ])
            else:
                new_c = _host_isim(new_ls, new_n)
            near = np.abs(new_c - thr) < 1e-5
            if criterion == "tolerance-diameter":
                old_c = np.where(old_n < 2, 0.0, _host_isim(old_ls, old_n))
                tol_n = np.maximum(
                    tol * (np.exp(-1e-3 * old_n) - np.exp(-1.0)), 0.0
                )
                near |= np.abs(new_c - (old_c - tol_n)) < 1e-5
            diff = dev != host
            check(
                not (diff & ~near).any(),
                f"merge_accept_batch({criterion}, t={thr}) differs from "
                f"the host criterion on {int((diff & ~near).sum())} "
                "candidates away from the bound",
            )
            flips += int(diff.sum())
            rep.line(
                f"phase1 merge {criterion} t={thr}", candidates=n_cand,
                accepted=int(host.sum()), near_bound_flips=int(diff.sum()),
                ok=True,
            )
    return flips


def check_tanimoto(rep, rows, g_bits):
    import jax
    import jax.numpy as jnp

    from bblean_tpu.ops.tanimoto import intersection_matmul, tanimoto_matmul

    q = jnp.asarray(rows)
    c = jnp.asarray(g_bits)
    inter = np.asarray(jax.jit(intersection_matmul)(q, c))
    sims = np.asarray(jax.jit(tanimoto_matmul)(q, c))
    ref = rows.astype(np.float64) @ g_bits.T.astype(np.float64)
    check(np.array_equal(inter, ref), "tanimoto_matmul intersections differ")
    union = np.maximum(
        rows.sum(1)[:, None] + g_bits.sum(1)[None, :] - ref, 1
    )
    err = float(np.abs(sims - ref / union).max())
    check(err <= 1e-6, f"tanimoto_matmul off by {err}")
    rep.line(
        "phase1 tanimoto_matmul", queries=len(rows), centroids=len(g_bits),
        max_abs_err=err, ok=True,
    )


def check_division(rep, max_den=4096):
    r"""``div_rn`` against NumPy's IEEE f32 quotient for every integer pair
    ``num <= den <= max_den`` (every similarity ratio of the engine), and
    how many raw device quotients differ from IEEE."""
    import jax
    import jax.numpy as jnp

    from bblean_tpu.ops.divide import div_rn

    nums = np.arange(0, max_den + 1, dtype=np.float32)
    dens = np.arange(1, max_den + 1, dtype=np.float32)
    n, d = (x.ravel() for x in np.meshgrid(nums, dens, indexing="ij"))
    keep = n <= d
    n, d = n[keep], d[keep]
    ref = n / d
    dn, dd = jnp.asarray(n), jnp.asarray(d)
    got = np.asarray(jax.jit(div_rn)(dn, dd))
    raw = np.asarray(jax.jit(jnp.divide)(dn, dd))
    bad = int((got != ref).sum())
    check(bad == 0, f"div_rn differs from IEEE on {bad} integer ratios")
    rep.line(
        "phase1 div_rn", pairs=len(n), mismatches=bad,
        raw_divide_not_ieee=int((raw != ref).sum()), ok=True,
    )


def phase_kernels(rep, *, m=8192, g_live=4096, g_cap=8192, block=1024,
                  n_groups=1024, fc=256, tan_centroids=4096, n_cand=2048,
                  seed=0):
    rng = np.random.default_rng(seed)
    check_division(rep, max_den=min(4096, 2 * g_cap))
    rows, g_bits = check_route(rep, rng, m, g_live, g_cap, block)
    check_tanimoto(rep, rows, g_bits[:tan_centroids])
    check_search(rep, rng, m, n_groups, fc, F // 8)
    check_merges(rep, rng, n_cand=n_cand)


# -- phase 2: engine correctness at a cut size ---------------------------------


def _batch_fit(packed, threshold, batch, device=None):
    import jax

    from bblean_tpu.engine.batch import BatchTree

    def fit():
        tree = BatchTree(
            F, threshold=threshold, batch_size=batch,
            initial_capacity=2 * len(packed),
        )
        tree.fit_packed(packed, range(len(packed)))
        return tree

    if device is None:
        return fit()
    with jax.default_device(device):
        tree = fit()
        tree.assignments()  # pull results while the device is current
        return tree


def phase_engine(rep, *, rows=20_000, batch=1024, thresholds=(0.65, 0.3)):
    import jax

    from bblean_tpu import BitBirch
    from bblean_tpu.fingerprints import make_fake_fingerprints

    packed = make_fake_fingerprints(rows, seed=SEED)
    bits = _unpack(packed).astype(np.int64)
    cpu = jax.devices("cpu")[0]
    for thr in thresholds:
        n_exact = len(BitBirch(threshold=thr).fit(packed).get_cluster_mol_ids())
        t0 = time.perf_counter()
        tree = _batch_fit(packed, thr, batch)
        labels = tree.assignments()
        wall = time.perf_counter() - t0
        sizes = tree.cluster_sizes()
        ncl = len(sizes)
        check(labels.shape == (rows,) and labels.min() >= 0,
              f"t={thr}: rows left unassigned")
        check(int(sizes.sum()) == rows, f"t={thr}: mass not conserved")
        check(
            np.array_equal(np.bincount(labels, minlength=ncl), sizes),
            f"t={thr}: labels disagree with cluster sizes",
        )
        ls = tree.linear_sums().astype(np.int64)
        member_ls = np.zeros_like(ls)
        np.add.at(member_ls, labels, bits)
        check(np.array_equal(ls, member_ls),
              f"t={thr}: device linear sums differ from member sums")
        multi = sizes >= 2
        worst = _check_cohesion(ls[multi], sizes[multi], thr, f"t={thr}")
        # The band tests/test_batch_engine.py holds against the exact engine
        check(
            0.5 * n_exact <= ncl <= 1.3 * n_exact,
            f"t={thr}: {ncl} clusters outside [0.5, 1.3] x exact {n_exact}",
        )
        again = _batch_fit(packed, thr, batch).assignments()
        deterministic = bool(np.array_equal(labels, again))
        check(deterministic, f"t={thr}: two device fits gave different labels")
        cpu_tree = _batch_fit(packed, thr, batch, device=cpu)
        cpu_labels = cpu_tree.assignments()
        cpu_ncl = cpu_tree.num_clusters
        check(
            abs(cpu_ncl - ncl) <= 0.01 * ncl,
            f"t={thr}: CPU backend found {cpu_ncl} clusters vs {ncl}",
        )
        rep.line(
            f"phase2 BatchTree {rows} rows t={thr}", clusters=ncl,
            exact_clusters=n_exact, worst_isim=round(worst, 6),
            fit_wall_s=round(wall, 3), deterministic=deterministic,
            cpu_clusters=cpu_ncl,
            cpu_labels_identical=bool(np.array_equal(labels, cpu_labels)),
            ok=True,
        )


# -- phase 3: the device path at real size ------------------------------------


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _memory_line(rep, what, compiled) -> None:
    ma = compiled.memory_analysis()
    if ma is None:
        rep.line(what, memory_analysis="unavailable")
        return
    rep.line(
        what,
        argument_bytes=ma.argument_size_in_bytes,
        output_bytes=ma.output_size_in_bytes,
        alias_bytes=ma.alias_size_in_bytes,
        temp_bytes=ma.temp_size_in_bytes,
        generated_code_bytes=ma.generated_code_size_in_bytes,
    )


def _scan_program_memory(rep, tree, dev_fps, what):
    import jax.numpy as jnp

    from bblean_tpu.engine.batch import _scan_fit_packed

    m = tree.batch_size
    lowered = _scan_fit_packed.lower(
        tree.state, dev_fps, jnp.int32(0), jnp.int32(0),
        jnp.float32(tree.threshold), jnp.float32(tree.tolerance),
        k=tree.scan_batches, m=m, n_features=tree.n_features,
        criterion=tree.merge_criterion, block=tree.route_block,
        max_rounds=tree.max_rounds, narrow=m // 4, split_k=tree.split_k,
        fanout=tree.fanout,
    )
    _memory_line(rep, what, lowered.compile())


def _scale_batch(rep, dev_fps, threshold, batch, memory_analysis=False):
    from bblean_tpu.engine.batch import BatchTree

    n = int(dev_fps.shape[0])
    tree = BatchTree(
        F, threshold=threshold, batch_size=batch, initial_capacity=n + batch + 1,
    )
    t0 = time.perf_counter()
    tree.warm_programs(dev_fps)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.fit_packed(dev_fps, range(n))
    ncl = tree.num_clusters  # device sync
    wall = time.perf_counter() - t0
    sizes = tree.cluster_sizes()
    check(int(sizes.sum()) == n, f"1M t={threshold}: mass not conserved")
    labels = tree.assignments()
    check(labels.shape == (n,) and labels.min() >= 0,
          f"1M t={threshold}: rows left unassigned")
    ls, cnt = _multi_member_sums(tree.state)
    _check_cohesion(ls, cnt, threshold, f"1M t={threshold}")
    rep.line(
        f"phase3 BatchTree.fit_packed resident {n} rows t={threshold}",
        fit_wall_s=round(wall, 3), fps_per_s=round(n / wall, 1),
        clusters=ncl, cold_compile_s=round(compile_s, 3),
        peak_device_bytes=_peak_bytes(),
    )
    if memory_analysis:  # threshold is traced: one program serves both
        _scan_program_memory(
            rep, tree, dev_fps, "phase3 scan-window memory_analysis"
        )


def _scale_sharded(rep, dev_fps, threshold, batch, n_devices=1):
    from bblean_tpu.parallel import ShardedForest, get_mesh

    n = int(dev_fps.shape[0])
    mesh = get_mesh(n_devices)
    forest = ShardedForest(
        F, mesh, threshold=threshold, batch_size=batch,
        initial_capacity=2 * (n // n_devices) + 2 * batch,
    )
    t0 = time.perf_counter()
    forest.warm_programs(dev_fps)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    forest.fit_packed(dev_fps)
    forest.merge()
    ncl = forest.num_clusters  # device sync
    wall = time.perf_counter() - t0
    sizes = forest.cluster_sizes()
    check(int(sizes.sum()) == n,
          f"sharded x{n_devices} t={threshold}: mass not conserved")
    ls, cnt = _multi_member_sums(forest.state, stacked=True)
    _check_cohesion(ls, cnt, threshold, f"sharded x{n_devices} t={threshold}")
    rep.line(
        f"ShardedForest {n_devices}-device mesh {n} rows t={threshold}",
        fit_merge_wall_s=round(wall, 3), fps_per_s=round(n / wall, 1),
        clusters=ncl, cold_compile_s=round(compile_s, 3),
        peak_device_bytes=_peak_bytes(),
    )
    return ncl


def _scale_cli(rep, dev_fps, threshold, batch, workdir: Path):
    import pickle

    from bblean_tpu._timer import Timer
    from bblean_tpu.engine.run import PlainConsole, run_batch_engine

    n = int(dev_fps.shape[0])
    workdir.mkdir(parents=True, exist_ok=True)
    npy = workdir / "fps.npy"
    np.save(npy, np.asarray(dev_fps))
    walls = []
    for attempt in ("cold", "warm"):
        out = workdir / f"run-{attempt}"
        out.mkdir(exist_ok=True)
        config: dict = {}
        timer = Timer()
        t0 = time.perf_counter()
        run_batch_engine(
            [npy], out, config, PlainConsole(silent=True), timer,
            threshold=threshold, merge_criterion="diameter", tolerance=0.05,
            n_features=None, input_is_packed=True, max_fps=None,
            save_centroids=False, batch_size=batch,
        )
        walls.append(time.perf_counter() - t0)
        with open(out / "clusters.pkl", "rb") as f:
            clusters = pickle.load(f)
        check(len(clusters) == config["n_clusters"],
              "bb run: clusters.pkl disagrees with the cluster count")
        check(sum(len(c) for c in clusters) == n,
              "bb run: clusters.pkl does not hold every molecule once")
        rep.line(
            f"phase3 bb run --engine batch ({attempt}) {n} rows "
            f"t={threshold}",
            wall_s=round(walls[-1], 3), fit_s=round(timer.timings["fit"], 3),
            extract_s=round(timer.timings["extract"], 3),
            fps_per_s=round(n / walls[-1], 1), clusters=len(clusters),
            peak_device_bytes=_peak_bytes(),
        )
    rep.line(
        f"phase3 bb run cold compile estimate t={threshold}",
        cold_minus_warm_s=round(walls[0] - walls[1], 3),
    )


def phase_scale(rep, *, rows=1 << 20, batch=8192, workdir=ROOT / ".smoke",
                seed=SEED):
    t0 = time.perf_counter()
    dev_fps = device_fingerprints(rows, seed)
    dev_fps.block_until_ready()
    rep.line("phase3 data", rows=rows,
             generate_s=round(time.perf_counter() - t0, 3))
    for thr in (0.65, 0.3):
        _scale_batch(rep, dev_fps, thr, batch, memory_analysis=thr == 0.65)
    _scale_sharded(rep, dev_fps, 0.3, batch)
    _scale_cli(rep, dev_fps, 0.3, batch, workdir)


def phase_four_cards(rep, *, rows_per_card=1 << 20, batch=8192, n_cards=4,
                     seed=SEED):
    dev_fps = device_fingerprints(n_cards * rows_per_card, seed)
    dev_fps.block_until_ready()
    n4 = _scale_sharded(rep, dev_fps, 0.65, batch, n_devices=n_cards)
    n1 = _scale_sharded(rep, dev_fps, 0.65, batch, n_devices=1)
    # At t=0.65 ~98% of clusters are singletons: the group-gated merge can
    # only leave apart multi-member clusters that straddle shards, which
    # the 8-shard CPU-mesh goldens put at +0.3% over one device
    ratio = n4 / n1
    check(
        0.98 <= ratio <= 1.02,
        f"{n_cards}-card count {n4} vs 1-card {n1}: ratio {ratio:.4f} "
        "outside [0.98, 1.02]",
    )
    rep.line(f"four-cards {n_cards} vs 1 card", clusters_ratio=round(ratio, 6))


def build_native() -> None:
    subprocess.run(["make", "--no-print-directory", "native"], cwd=ROOT,
                   check=True, stdout=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over a 4-GPU mesh")
    args = ap.parse_args(argv)

    import jax

    n_cards = 4 if args.four_cards else 1
    require_gpu(jax.devices(), n_cards)
    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()
    rep = Report(card_name())
    dev = jax.devices()[0]
    rep.line("device", kind=repr(dev.device_kind), count=len(jax.devices()),
             bytes_limit=(dev.memory_stats() or {}).get("bytes_limit"))
    build_native()

    if args.four_cards:
        phase_four_cards(rep)
    else:
        for name, phase in (
            ("phase1", lambda: phase_kernels(rep)),
            ("phase2", lambda: phase_engine(rep)),
            ("phase3", lambda: phase_scale(rep)),
        ):
            t0 = time.perf_counter()
            phase()
            rep.line(f"{name} done", wall_s=round(time.perf_counter() - t0, 3))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
