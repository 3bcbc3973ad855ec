r"""``bb`` command-line interface.

Command surface mirrors the reference CLI (``bblean/cli.py``): clustering
(``run``, ``multiround``), fingerprint file management (``fps-from-smiles``,
``fps-split``, ``fps-shuffle``, ``fps-merge``, ``fps-info``) and analysis
(``summary``, ``plot-*``).  Run-dir conventions are identical: a random
8-hex-digit directory under ``bb_run_outputs/`` containing ``clusters.pkl``,
``cluster-centroids-packed.pkl``, ``config.json``, ``timings.json``,
``monitor-rss.csv`` / ``max-rss.txt`` and ``input-fps/`` symlinks.

Device addition: ``bb run --engine batch|sharded`` clusters on the
accelerator with the level-synchronous batched engine (the device half lives
in ``bblean_tpu.engine.run``); the default ``--engine exact`` produces
reference-identical labels on the host.

Built on click (the reference uses typer, which wraps click).
"""

from __future__ import annotations

import json
import pickle
import random
import shutil
import sys
import typing as tp
from pathlib import Path

import click
import numpy as np

from bblean_tpu._config import DEFAULTS, collect_system_specs_and_dump_config
from bblean_tpu._console import get_console
from bblean_tpu._timer import Timer

__all__ = ["main"]


@click.group(name="bb")
@click.version_option(package_name="bblean-tpu", prog_name="bb")
def main() -> None:
    r"""bblean-tpu: BitBIRCH clustering of molecular libraries on JAX devices."""


# -- helpers ------------------------------------------------------------------


def _discover_input_files(input_: Path | None) -> list[Path]:
    if input_ is None:
        input_ = Path.cwd() / "bb_inputs"
        input_.mkdir(exist_ok=True)
    if input_.is_dir():
        files = sorted(input_.glob("*.npy"))
        if not files:
            raise click.ClickException(f"No *.npy files found in {input_}")
        return files
    return [input_]


def _make_run_dir(out_dir: Path | None, overwrite: bool) -> Path:
    if out_dir is None:
        unique_id = format(random.getrandbits(32), "08x")
        out_dir = Path.cwd() / "bb_run_outputs" / unique_id
    out_dir.mkdir(exist_ok=True, parents=True)
    if not overwrite and any(p.is_file() for p in out_dir.iterdir()):
        raise click.ClickException(
            f"Output dir {out_dir} has files; pass --overwrite to allow"
        )
    return out_dir


def _link_input_fps(out_dir: Path, files: tp.Sequence[Path], copy: bool) -> None:
    dest = (out_dir / "input-fps").resolve()
    dest.mkdir(exist_ok=True)
    for f in files:
        target = dest / f.name
        if target.exists() or target.is_symlink():
            continue
        if copy:
            shutil.copy(f, target)
        else:
            target.symlink_to(f.resolve())


def _dump_cluster_outputs(tree, out_dir: Path, save_centroids: bool) -> None:
    if save_centroids:
        output = tree.get_centroids_mol_ids()
        with open(out_dir / "clusters.pkl", "wb") as f:
            pickle.dump(output["mol_ids"], f)
        with open(out_dir / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump(output["centroids"], f)
    else:
        with open(out_dir / "clusters.pkl", "wb") as f:
            pickle.dump(tree.get_cluster_mol_ids(), f)


# -- clustering commands --------------------------------------------------------


@main.command("run")
@click.argument("input_", metavar="[INPUT]", required=False, type=Path)
@click.option("-o", "--out-dir", type=Path, default=None, help="Dir to dump the output files")
@click.option("--overwrite", is_flag=True, help="Allow overwriting output files")
@click.option("-b", "--branching", "branching_factor", default=DEFAULTS.branching_factor, show_default=True, help="BitBIRCH branching factor")
@click.option("-t", "--threshold", default=DEFAULTS.threshold, show_default=True, help="Threshold for merge criterion")
@click.option("--refine-threshold-change", default=DEFAULTS.refine_threshold_change, help="Threshold delta for the refinement criterion")
@click.option("--save-tree/--no-save-tree", default=False)
@click.option("--save-centroids/--no-save-centroids", default=True)
@click.option("-m", "--set-merge", "merge_criterion", default=DEFAULTS.merge_criterion, show_default=True, help="Merge criterion for initial clustering")
@click.option("--set-refine-merge", "refine_merge_criterion", default=DEFAULTS.refine_merge_criterion, show_default=True, help="Merge criterion for refinement")
@click.option("--tolerance", default=DEFAULTS.tolerance, show_default=True)
@click.option("--refine-num", default=0, help="Num. of largest clusters to refine (0 = no refinement)")
@click.option("--refine-rounds", default=None, type=int, hidden=True)
@click.option("--recluster-rounds", default=0, hidden=True)
@click.option("--recluster-shuffle/--no-recluster-shuffle", default=True, hidden=True)
@click.option("--n-features", default=None, type=int, help="Fingerprint bit count (needed for packed inputs not a multiple of 8)")
@click.option("--packed-input/--unpacked-input", "input_is_packed", default=True)
@click.option("--engine", type=click.Choice(["exact", "batch", "sharded"]), default="exact", show_default=True, help="exact: reference-identical labels on host; batch: batched engine on the accelerator; sharded: SPMD over every visible device")
@click.option("--batch-size", "engine_batch_size", default=8192, show_default=True, help="[batch engine] rows per device step")
@click.option("--fanout", "engine_fanout", default=None, type=int, help="[batch engine] clusters per group before a split (default: auto-tuned from the input size)")
@click.option("--monitor-mem/--no-monitor-mem", "monitor_rss", default=True)
@click.option("--monitor-mem-seconds", "monitor_rss_interval_s", default=1.0, hidden=True)
@click.option("--max-fps", default=None, type=int, hidden=True)
@click.option("--copy/--no-copy", "copy_inputs", default=False, help="Copy input files instead of symlinking")
@click.option("-v/-V", "--verbose/--no-verbose", default=True)
def _run(
    input_: Path | None,
    out_dir: Path | None,
    overwrite: bool,
    branching_factor: int,
    threshold: float,
    refine_threshold_change: float,
    save_tree: bool,
    save_centroids: bool,
    merge_criterion: str,
    refine_merge_criterion: str,
    tolerance: float,
    refine_num: int,
    refine_rounds: int | None,
    recluster_rounds: int,
    recluster_shuffle: bool,
    n_features: int | None,
    input_is_packed: bool,
    engine: str,
    engine_batch_size: int,
    engine_fanout: int | None,
    monitor_rss: bool,
    monitor_rss_interval_s: float,
    max_fps: int | None,
    copy_inputs: bool,
    verbose: bool,
) -> None:
    r"""Run standard BitBIRCH clustering over `*.npy` fingerprint files."""
    from bblean_tpu._memory import launch_monitor_rss_daemon
    from bblean_tpu.fingerprints import _get_fps_file_num

    console = get_console(silent=not verbose)
    if refine_rounds is None:
        refine_rounds = 1 if refine_num > 0 else 0
    if refine_rounds > 0 and refine_num == 0:
        refine_num = 1

    input_files = _discover_input_files(input_)
    out_dir = _make_run_dir(out_dir, overwrite)

    config: dict[str, tp.Any] = {
        "command": "run",
        "engine": engine,
        "input_files": [str(p.resolve()) for p in input_files],
        "num_fps_present": [_get_fps_file_num(p) for p in input_files],
        "out_dir": str(out_dir.resolve()),
        "branching_factor": branching_factor,
        "threshold": threshold,
        "merge_criterion": merge_criterion,
        "tolerance": tolerance,
        "refine_num": refine_num,
        "refine_rounds": refine_rounds,
        "recluster_rounds": recluster_rounds,
        "refine_merge_criterion": refine_merge_criterion,
        "refine_threshold_change": refine_threshold_change,
        "n_features": n_features,
        "input_is_packed": input_is_packed,
        "max_fps": max_fps,
    }
    console.print_banner()
    console.print_config(config)

    if monitor_rss:
        launch_monitor_rss_daemon(out_dir, monitor_rss_interval_s)

    timer = Timer()
    timer.init_timing("total")
    if engine == "sharded":
        from bblean_tpu.engine.run import run_sharded_engine

        run_sharded_engine(
            input_files, out_dir, config, console, timer,
            threshold=threshold, merge_criterion=merge_criterion,
            tolerance=tolerance, n_features=n_features,
            input_is_packed=input_is_packed, max_fps=max_fps,
            save_centroids=save_centroids,
            batch_size=engine_batch_size,
            refine_num=refine_num, refine_rounds=refine_rounds,
            refine_merge_criterion=refine_merge_criterion,
            refine_threshold_change=refine_threshold_change,
            recluster_rounds=recluster_rounds,
            recluster_shuffle=recluster_shuffle,
        )
    elif engine == "batch":
        from bblean_tpu.engine.run import run_batch_engine

        run_batch_engine(
            input_files, out_dir, config, console, timer,
            threshold=threshold, merge_criterion=merge_criterion,
            tolerance=tolerance, n_features=n_features,
            input_is_packed=input_is_packed, max_fps=max_fps,
            save_centroids=save_centroids,
            batch_size=engine_batch_size, fanout=engine_fanout,
            refine_num=refine_num, refine_rounds=refine_rounds,
            refine_merge_criterion=refine_merge_criterion,
            refine_threshold_change=refine_threshold_change,
            recluster_rounds=recluster_rounds,
            recluster_shuffle=recluster_shuffle,
        )
    else:
        from bblean_tpu.tree import BitBirch

        tree = BitBirch(
            branching_factor=branching_factor,
            threshold=threshold,
            merge_criterion=merge_criterion,
            tolerance=tolerance,
        )
        with console.status("[italic]BitBirching...[/italic]", spinner="dots"):
            for file in input_files:
                tree.fit(
                    file,
                    n_features=n_features,
                    input_is_packed=input_is_packed,
                    max_fps=max_fps,
                )
        if recluster_rounds != 0 or refine_rounds != 0:
            tree.set_merge(
                refine_merge_criterion,
                tolerance=tolerance,
                threshold=threshold + refine_threshold_change,
            )
            for r in range(refine_rounds):
                with console.status(
                    f"[italic]Refinement, round {r + 1}...[/italic]",
                    spinner="dots",
                ):
                    tree.refine_inplace(
                        input_files if len(input_files) > 1 else input_files[0],
                        input_is_packed=input_is_packed,
                        n_largest=refine_num,
                    )
            for r in range(recluster_rounds):
                with console.status(
                    f"[italic]Reclustering, round {r + 1}...[/italic]",
                    spinner="dots",
                ):
                    tree.recluster_inplace(shuffle=recluster_shuffle)
        timer.end_timing("total", console, indent=False)
        console.print_peak_mem(out_dir)
        if save_tree:
            tree.save(out_dir / "bitbirch.pkl")
        tree.delete_internal_nodes()
        _dump_cluster_outputs(tree, out_dir, save_centroids)

    if "total" in timer._starts:
        timer.end_timing("total", console, indent=False)
    console.print_peak_hbm()
    collect_system_specs_and_dump_config(config)
    timer.dump(out_dir / "timings.json")
    _link_input_fps(out_dir, input_files, copy_inputs)
    console.print(f"Outputs in: {out_dir}")


@main.command("multiround")
@click.argument("input_", metavar="[INPUT]", required=False, type=Path)
@click.option("-o", "--out-dir", type=Path, default=None)
@click.option("--overwrite", is_flag=True)
@click.option("-b", "--branching", "branching_factor", default=DEFAULTS.branching_factor, show_default=True)
@click.option("-t", "--threshold", default=DEFAULTS.threshold, show_default=True)
@click.option("--midsection-threshold-change", default=DEFAULTS.refine_threshold_change)
@click.option("-m", "--set-merge", "initial_merge_criterion", default=DEFAULTS.merge_criterion, show_default=True)
@click.option("--set-midsection-merge", "midsection_merge_criterion", default=DEFAULTS.refine_merge_criterion, show_default=True)
@click.option("--set-final-merge", "final_merge_criterion", default=None)
@click.option("--tolerance", default=DEFAULTS.tolerance, show_default=True)
@click.option("-p", "--num-processes", "num_initial_processes", default=10, show_default=True, help="Processes for the initial round")
@click.option("--num-midsection-processes", default=None, type=int)
@click.option("--num-midsection-rounds", default=1, show_default=True)
@click.option("--bin-size", default=10, show_default=True)
@click.option("--refinement", "refinement_before_midsection", type=click.Choice(["full", "split", "none"]), default="full", show_default=True)
@click.option("--split-largest/--no-split-largest", "split_largest", default=False)
@click.option("--save-tree/--no-save-tree", default=False)
@click.option("--save-centroids/--no-save-centroids", default=True)
@click.option("--n-features", default=None, type=int)
@click.option("--packed-input/--unpacked-input", "input_is_packed", default=True)
@click.option("--monitor-mem/--no-monitor-mem", "monitor_rss", default=True)
@click.option("--max-fps", default=None, type=int, hidden=True)
@click.option("--cleanup/--no-cleanup", default=True)
@click.option("--copy/--no-copy", "copy_inputs", default=False)
@click.option("-v/-V", "--verbose/--no-verbose", default=True)
def _multiround(
    input_: Path | None,
    out_dir: Path | None,
    overwrite: bool,
    branching_factor: int,
    threshold: float,
    midsection_threshold_change: float,
    initial_merge_criterion: str,
    midsection_merge_criterion: str,
    final_merge_criterion: str | None,
    tolerance: float,
    num_initial_processes: int,
    num_midsection_processes: int | None,
    num_midsection_rounds: int,
    bin_size: int,
    refinement_before_midsection: str,
    split_largest: bool,
    save_tree: bool,
    save_centroids: bool,
    n_features: int | None,
    input_is_packed: bool,
    monitor_rss: bool,
    max_fps: int | None,
    cleanup: bool,
    copy_inputs: bool,
    verbose: bool,
) -> None:
    r"""Parallel multi-round clustering over many `*.npy` shards."""
    from bblean_tpu._memory import launch_monitor_rss_daemon
    from bblean_tpu.multiround import run_multiround_bitbirch

    console = get_console(silent=not verbose)
    input_files = _discover_input_files(input_)
    out_dir = _make_run_dir(out_dir, overwrite)
    config: dict[str, tp.Any] = {
        "command": "multiround",
        "input_files": [str(p.resolve()) for p in input_files],
        "out_dir": str(out_dir.resolve()),
        "branching_factor": branching_factor,
        "threshold": threshold,
        "initial_merge_criterion": initial_merge_criterion,
        "midsection_merge_criterion": midsection_merge_criterion,
        "final_merge_criterion": final_merge_criterion,
        "tolerance": tolerance,
        "num_processes": num_initial_processes,
        "num_midsection_rounds": num_midsection_rounds,
        "bin_size": bin_size,
        "refinement_before_midsection": refinement_before_midsection,
        "n_features": n_features,
        "input_is_packed": input_is_packed,
    }
    console.print_banner()
    console.print_multiround_config(config)
    if monitor_rss:
        launch_monitor_rss_daemon(out_dir)

    timer = run_multiround_bitbirch(
        input_files,
        out_dir,
        n_features=n_features,
        input_is_packed=input_is_packed,
        num_initial_processes=num_initial_processes,
        num_midsection_processes=num_midsection_processes,
        initial_merge_criterion=initial_merge_criterion,
        branching_factor=branching_factor,
        threshold=threshold,
        midsection_threshold_change=midsection_threshold_change,
        tolerance=tolerance,
        num_midsection_rounds=num_midsection_rounds,
        bin_size=bin_size,
        refinement_before_midsection=refinement_before_midsection,
        split_largest_after_each_midsection_round=split_largest,
        midsection_merge_criterion=midsection_merge_criterion,
        final_merge_criterion=final_merge_criterion,
        save_tree=save_tree,
        save_centroids=save_centroids,
        max_fps=max_fps,
        verbose=verbose,
        cleanup=cleanup,
    )
    collect_system_specs_and_dump_config(config)
    timer.dump(out_dir / "timings.json")
    _link_input_fps(out_dir, input_files, copy_inputs)
    console.print(f"Outputs in: {out_dir}")


# -- fingerprint commands ------------------------------------------------------


@main.command("fps-from-smiles", help="Featurize `*.smi` files into packed fingerprint `*.npy` files (requires RDKit)")
@click.argument("smiles_files", nargs=-1, required=True, type=Path)
@click.option("-o", "--out-dir", type=Path, default=Path("bb_inputs"), show_default=True)
@click.option("--out-name", default="fps", show_default=True)
@click.option("--kind", default=DEFAULTS.fp_kind, show_default=True, type=click.Choice(["rdkit", "ecfp4", "ecfp6"]))
@click.option("--n-features", default=DEFAULTS.n_features, show_default=True)
@click.option("--sanitize", default="all", type=click.Choice(["all", "minimal"]), show_default=True)
@click.option("--skip-invalid/--no-skip-invalid", default=False)
@click.option("--pack/--no-pack", default=True)
@click.option("-p", "--num-processes", default=1, show_default=True)
@click.option("--batch-size", default=50_000, show_default=True, help="SMILES per output file in parallel mode")
@click.option(
    "--single-file/--multi-file",
    "single_file",
    default=False,
    show_default=True,
    help="In parallel mode, featurize into ONE output array via shared"
    " memory instead of one .npy per batch",
)
@click.option("-v/-V", "--verbose/--no-verbose", default=True)
def _fps_from_smiles(
    smiles_files: tuple[Path, ...],
    out_dir: Path,
    out_name: str,
    kind: str,
    n_features: int,
    sanitize: str,
    skip_invalid: bool,
    pack: bool,
    num_processes: int,
    batch_size: int,
    single_file: bool,
    verbose: bool,
) -> None:
    import multiprocessing as mp

    from bblean_tpu.fingerprints import _FingerprintFileCreator, fps_from_smiles
    from bblean_tpu.smiles import (
        _iter_idxs_and_smiles_batches,
        iter_smiles_from_paths,
    )

    console = get_console(verbose)
    out_dir.mkdir(exist_ok=True, parents=True)
    files = [Path(f) for f in smiles_files]
    if num_processes > 1 and single_file:
        _fps_from_smiles_shared_memory(
            files, out_dir, out_name, kind, n_features, sanitize,
            skip_invalid, pack, num_processes, batch_size, console,
        )
        return
    if num_processes <= 1:
        smiles = list(iter_smiles_from_paths(files))
        result = fps_from_smiles(
            smiles, kind=kind, n_features=n_features, sanitize=sanitize,
            skip_invalid=skip_invalid, pack=pack,
        )
        if skip_invalid:
            fps, invalid = result
            if len(invalid):
                console.print(f"Skipped {len(invalid)} invalid smiles")
                np.save(out_dir / f"invalid-{out_name}.npy", invalid)
        else:
            fps = result
        np.save(out_dir / out_name, fps)
        console.print(f"Wrote {len(fps)} fingerprints to {out_dir / out_name}.npy")
        return

    batches = list(_iter_idxs_and_smiles_batches(files, batch_size))
    digits = len(str(len(batches)))
    worker = _FingerprintFileCreator(
        dtype="uint8", out_dir=out_dir, out_name=out_name, digits=digits,
        pack=pack, kind=kind, n_features=n_features, sanitize=sanitize,
        skip_invalid=skip_invalid, verbose=verbose,
    )
    ctx = mp.get_context("forkserver" if sys.platform == "linux" else None)
    with ctx.Pool(processes=min(num_processes, len(batches))) as pool:
        pool.map(worker, batches)
    console.print(f"Wrote {len(batches)} fingerprint files to {out_dir}")


def _fps_from_smiles_shared_memory(
    files: list[Path],
    out_dir: Path,
    out_name: str,
    kind: str,
    n_features: int,
    sanitize: str,
    skip_invalid: bool,
    pack: bool,
    num_processes: int,
    batch_size: int,
    console,
) -> None:
    r"""Parallel featurization into ONE output ``.npy``.

    Workers write disjoint row ranges of a ``multiprocessing.shared_memory``
    array plus an invalid-row bitmask; invalid rows are dropped at the end.
    Parity: reference ``bblean/cli.py:1652-1701``.
    """
    import multiprocessing as mp
    import multiprocessing.shared_memory as shmem

    from bblean_tpu.fingerprints import _FingerprintArrayFiller
    from bblean_tpu.smiles import _iter_ranges_and_smiles_batches, calc_num_smiles

    num_smiles = calc_num_smiles(files)
    out_dim = (n_features + 7) // 8 if pack else n_features
    fps_shm = shmem.SharedMemory(create=True, size=max(num_smiles * out_dim, 1))
    mask_shm = shmem.SharedMemory(create=True, size=max(num_smiles, 1))
    try:
        # Zero the invalid mask: SharedMemory contents are not guaranteed
        np.ndarray((num_smiles,), dtype=np.bool_, buffer=mask_shm.buf)[:] = False
        filler = _FingerprintArrayFiller(
            invalid_mask_shmem_name=mask_shm.name,
            shmem_name=fps_shm.name,
            kind=kind,
            fp_size=n_features,
            pack=pack,
            dtype="uint8",
            num_smiles=num_smiles,
            sanitize=sanitize,
            skip_invalid=skip_invalid,
        )
        ctx = mp.get_context("forkserver" if sys.platform == "linux" else None)
        with ctx.Pool(processes=num_processes) as pool:
            pool.starmap(
                filler, _iter_ranges_and_smiles_batches(files, batch_size)
            )
        fps = np.ndarray((num_smiles, out_dim), dtype=np.uint8, buffer=fps_shm.buf)
        mask = np.ndarray((num_smiles,), dtype=np.bool_, buffer=mask_shm.buf)
        if skip_invalid and mask.any():
            invalid = mask.nonzero()[0]
            fps = np.delete(fps, invalid, axis=0)
            np.save(out_dir / f"invalid-{out_name}.npy", invalid)
            console.print(f"Skipped {invalid.size} invalid smiles")
        else:
            fps = fps.copy()  # detach from shared memory before unlink
        np.save(out_dir / out_name, fps)
        console.print(
            f"Wrote {len(fps)} fingerprints to {out_dir / out_name}.npy"
        )
    finally:
        fps_shm.close()
        fps_shm.unlink()
        mask_shm.close()
        mask_shm.unlink()


@main.command("fps-info", help="Inspect fingerprint `*.npy` files")
@click.argument("files", nargs=-1, required=True, type=Path)
def _fps_info(files: tuple[Path, ...]) -> None:
    from bblean_tpu.fingerprints import _print_fps_file_info

    for f in files:
        _print_fps_file_info(Path(f))


@main.command("fps-split", help="Split a fingerprint `*.npy` file into shards")
@click.argument("input_", metavar="INPUT", type=Path)
@click.option("-n", "--num-splits", default=None, type=int)
@click.option("--split-size", default=None, type=int, help="Fingerprints per shard (alternative to -n)")
@click.option("-o", "--out-dir", type=Path, default=None)
def _fps_split(
    input_: Path, num_splits: int | None, split_size: int | None, out_dir: Path | None
) -> None:
    fps = np.load(input_, mmap_mode="r")
    if (num_splits is None) == (split_size is None):
        raise click.ClickException("Pass exactly one of -n/--num-splits or --split-size")
    if num_splits is not None:
        split_size = -(-len(fps) // num_splits)
    assert split_size is not None
    out_dir = out_dir if out_dir is not None else input_.parent
    out_dir.mkdir(exist_ok=True, parents=True)
    total = -(-len(fps) // split_size)
    digits = len(str(total))
    for i in range(total):
        shard = fps[i * split_size : (i + 1) * split_size]
        np.save(out_dir / f"{input_.stem}.{str(i).zfill(digits)}.npy", shard)
    click.echo(f"Wrote {total} shards to {out_dir}")


@main.command("fps-shuffle", help="Shuffle the rows of fingerprint `*.npy` files")
@click.argument("files", nargs=-1, required=True, type=Path)
@click.option("--seed", default=None, type=int)
@click.option("--suffix", default="shuffled", show_default=True)
def _fps_shuffle(files: tuple[Path, ...], seed: int | None, suffix: str) -> None:
    rng = np.random.default_rng(seed)
    for f in files:
        fps = np.load(f)
        rng.shuffle(fps)
        out = f.with_name(f"{f.stem}.{suffix}.npy")
        np.save(out, fps)
        click.echo(f"Wrote {out}")


@main.command("fps-merge", help="Merge fingerprint `*.npy` files into one")
@click.argument("files", nargs=-1, required=True, type=Path)
@click.option("-o", "--output", type=Path, required=True)
def _fps_merge(files: tuple[Path, ...], output: Path) -> None:
    arrays = [np.load(f, mmap_mode="r") for f in files]
    widths = {a.shape[1] for a in arrays}
    if len(widths) != 1:
        raise click.ClickException(f"Incompatible fingerprint widths: {widths}")
    merged = np.concatenate([np.asarray(a) for a in arrays])
    np.save(output, merged)
    click.echo(f"Wrote {len(merged)} fingerprints to {output}")


# -- analysis commands ---------------------------------------------------------


def _load_run_dir(run_dir: Path) -> tuple[list[list[int]], list[Path]]:
    clusters_path = run_dir / "clusters.pkl"
    if not clusters_path.exists():
        raise click.ClickException(f"{clusters_path} not found")
    with open(clusters_path, "rb") as f:
        clusters = pickle.load(f)
    fps_files = sorted((run_dir / "input-fps").glob("*.npy")) if (
        run_dir / "input-fps"
    ).is_dir() else []
    return clusters, fps_files


@main.command("summary", help="Summarize the clusters of a `bb run`/`bb multiround` output dir")
@click.argument("run_dir", type=Path)
@click.option("--top", default=20, show_default=True)
@click.option("--min-size", default=0, show_default=True)
@click.option("--chi/--no-chi", default=False, help="Compute the CHI quality index")
@click.option("--dbi/--no-dbi", default=False, help="Compute the DBI quality index")
@click.option("--dunn/--no-dunn", default=False, help="Compute the Dunn quality index")
@click.option("--dump-metrics", "dump_metrics_path", type=Path, default=None)
def _summary(
    run_dir: Path,
    top: int,
    min_size: int,
    chi: bool,
    dbi: bool,
    dunn: bool,
    dump_metrics_path: Path | None,
) -> None:
    from rich.table import Table

    from bblean_tpu.analysis import cluster_analysis

    console = get_console(True)
    clusters, fps_files = _load_run_dir(run_dir)
    fps_arg: tp.Any = fps_files if fps_files else None
    if fps_arg and len(fps_arg) == 1:
        fps_arg = fps_arg[0]
    ca = cluster_analysis(clusters, fps=fps_arg, top=top, min_size=min_size)

    console.print(f"Total fingerprints: {ca.total_fps:,}")
    console.print(f"Total clusters: {ca.all_clusters_num:,}")
    console.print(f"Singletons: {ca.all_singletons_num:,}")
    console.print(
        "Cluster sizes: "
        f"mean={ca.all_clusters_mean_size:.1f}"
        f" median={ca.all_clusters_median_size}"
        f" q1={ca.all_clusters_q1} q3={ca.all_clusters_q3}"
        f" max={ca.all_clusters_max_size}"
    )
    table = Table(title=f"Top {ca.clusters_num} clusters")
    table.add_column("label")
    table.add_column("size")
    if ca.has_fps:
        table.add_column("iSIM")
    for i in range(ca.clusters_num):
        row = [str(ca.labels[i]), str(ca.sizes[i])]
        if ca.has_fps:
            row.append(f"{ca.isims[i]:.4f}")
        table.add_row(*row)
    console.print(table)

    if (chi or dbi or dunn) and ca.has_fps:
        cluster_fps = [c for c in ca.get_top_cluster_fps() if len(c) >= 1]
        from bblean_tpu import metrics

        if chi:
            console.print(f"CHI (higher better): {metrics.jt_isim_chi(cluster_fps):.4f}")
        if dbi:
            console.print(f"DBI (lower better): {metrics.jt_dbi(cluster_fps):.4f}")
        if dunn:
            console.print(f"Dunn (higher better): {metrics.jt_isim_dunn(cluster_fps):.4f}")
    if dump_metrics_path is not None:
        ca.dump_metrics(dump_metrics_path)
        console.print(f"Metrics dumped to {dump_metrics_path}")


def _plot_command(kind: str):
    @click.argument("run_dir", type=Path)
    @click.option("--top", default=20, show_default=True)
    @click.option("-o", "--output", type=Path, default=None)
    def cmd(run_dir: Path, top: int, output: Path | None) -> None:
        from bblean_tpu import plotting

        clusters, fps_files = _load_run_dir(run_dir)
        fps_arg: tp.Any = fps_files if fps_files else None
        if fps_arg and len(fps_arg) == 1:
            fps_arg = fps_arg[0]
        out = output or run_dir / f"{kind}.png"
        getattr(plotting, f"{kind}_plot_from_clusters")(
            clusters, fps_arg, top=top, output=out
        )
        click.echo(f"Wrote {out}")

    cmd.__name__ = f"_plot_{kind}"
    return cmd


main.command("plot-summary", help="Bar + iSIM summary plot of a run dir")(
    _plot_command("summary")
)
main.command("plot-pops", help="Cluster population KDE plot of a run dir")(
    _plot_command("pops")
)
main.command("plot-pca", help="PCA embedding plot of the top clusters")(
    _plot_command("pca")
)
main.command("plot-tsne", help="t-SNE embedding plot of the top clusters")(
    _plot_command("tsne")
)
main.command("plot-umap", help="UMAP embedding plot of the top clusters")(
    _plot_command("umap")
)


if __name__ == "__main__":
    main()
