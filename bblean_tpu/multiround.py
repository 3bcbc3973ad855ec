r"""Multi-round (parallel) BitBirch workflow over fingerprint shards.

Host-process pipeline with reference-parity semantics
(``bblean/multiround.py``): an initial round fits one tree per ``.npy`` shard
(optionally with in-worker refinement), dumps its leaf CF buffers grouped by
minimal-uint dtype class (``round-1-bufs.label-X-uintNN.npy`` +
``round-1-idxs*.pkl``), then midsection rounds re-cluster binned batches of
buffer files (uint16-before-uint8 within each bin so the largest clusters are
re-inserted first) and a final round merges everything into ``clusters.pkl``.

This file-based path is the drop-in equivalent of the reference CLI's
``bb multiround`` and runs any number of processes on the host.  The
device equivalent — device-sharded builds with collective CF exchange
instead of files — lives in ``bblean_tpu.parallel.sharded``; use it
when the shards fit device memory and a mesh is available.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import pickle
import sys
import typing as tp
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from bblean_tpu._config import DEFAULTS
from bblean_tpu._console import get_console
from bblean_tpu._timer import Timer
from bblean_tpu.fingerprints import _get_fps_file_num
from bblean_tpu.tree import BitBirch
from bblean_tpu.utils import batched

__all__ = ["run_multiround_bitbirch"]


def _streaming_save_rows(
    rows: tp.Sequence[NDArray[np.integer]], path: Path | str
) -> None:
    r"""Write a list of equal-length 1-D arrays as one 2-D ``.npy`` without
    stacking them in memory."""
    first = np.ascontiguousarray(rows[0])
    header = np.lib.format.header_data_from_array_1_0(first)
    header["shape"] = (len(rows), len(first))
    path = Path(path)
    if not path.suffix:
        path = path.with_suffix(".npy")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        for row in rows:
            np.ascontiguousarray(row).tofile(f)


def _dump_round_buffers(
    out_dir: Path,
    to_fp: dict[str, list[NDArray[np.integer]]],
    to_mols: dict[str, list[list[int]]],
    label: str,
    round_idx: int,
) -> None:
    r"""Dump one worker's CF buffers + mol-index lists, grouped by dtype.

    ``uint8`` is zero-padded to ``uint08`` in file names so a plain
    lexicographic sort puts uint16 files first (largest clusters first).
    """
    for dtype_name, bufs in to_fp.items():
        suffix = f".label-{label}-{dtype_name.replace('8', '08')}"
        _streaming_save_rows(
            bufs, out_dir / f"round-{round_idx}-bufs{suffix}.npy"
        )
        with open(
            out_dir / f"round-{round_idx}-idxs{suffix}.pkl", "wb"
        ) as f:
            pickle.dump(to_mols[dtype_name], f)


def _collect_round_file_pairs(
    out_dir: Path, round_idx: int, console: tp.Any = None
) -> list[tuple[Path, Path]]:
    bufs = sorted(Path(out_dir).glob(f"round-{round_idx - 1}-bufs*.npy"))
    idxs = sorted(Path(out_dir).glob(f"round-{round_idx - 1}-idxs*.pkl"))
    if console is not None:
        console.print(f"    - Collected {len(bufs)} buffer-index file pairs")
    return list(zip(bufs, idxs))


def _dtype_bits_of(path: Path) -> int:
    return int(path.name.split("uint")[-1].split(".")[0])


def _bin_file_pairs(
    pairs: tp.Sequence[tuple[Path, Path]],
    bin_size: int,
    console: tp.Any = None,
) -> list[tuple[str, tuple[tuple[Path, Path], ...]]]:
    r"""Chunk file pairs into bins; within each bin, wider-dtype (larger
    cluster) files come first."""
    width = len(str(math.ceil(len(pairs) / bin_size)))
    bins = []
    for i, chunk in enumerate(batched(pairs, bin_size)):
        ordered = tuple(
            sorted(chunk, key=lambda p: _dtype_bits_of(p[0]), reverse=True)
        )
        bins.append((str(i).zfill(width), ordered))
    if console is not None:
        console.print(f"    - Chunked files into {len(bins)} batches")
    return bins


def _shard_index_ranges(
    files: tp.Sequence[Path],
) -> list[tuple[str, Path, int, int]]:
    r"""(label, path, global start idx, global end idx) per shard file."""
    out = []
    width = len(str(len(files)))
    offset = 0
    for i, file in enumerate(files):
        count = _get_fps_file_num(file)
        out.append((str(i).zfill(width), file, offset, offset + count))
        offset += count
    return out


class _InitialRound:
    r"""Worker: fit one shard, optionally refine, dump leaf CF buffers."""

    def __init__(
        self,
        branching_factor: int,
        threshold: float,
        tolerance: float,
        out_dir: Path | str,
        refinement_before_midsection: str,
        refine_threshold_change: float,
        refine_merge_criterion: str,
        n_features: int | None = None,
        max_fps: int | None = None,
        merge_criterion: str = DEFAULTS.merge_criterion,
        input_is_packed: bool = True,
    ) -> None:
        if refinement_before_midsection not in ("full", "split", "none"):
            raise ValueError(
                f"Unknown refinement kind {refinement_before_midsection}"
            )
        self.branching_factor = branching_factor
        self.threshold = threshold
        self.tolerance = tolerance
        self.out_dir = Path(out_dir)
        self.refinement = refinement_before_midsection
        self.refine_threshold_change = refine_threshold_change
        self.refine_merge_criterion = refine_merge_criterion
        self.n_features = n_features
        self.max_fps = max_fps
        self.merge_criterion = merge_criterion
        self.input_is_packed = input_is_packed

    def __call__(self, shard: tuple[str, Path, int, int]) -> None:
        label, fp_file, start_idx, end_idx = shard
        tree = BitBirch(
            branching_factor=self.branching_factor,
            threshold=self.threshold,
            merge_criterion=self.merge_criterion,
        )
        tree.fit(
            fp_file,
            reinsert_indices=range(start_idx, end_idx),
            n_features=self.n_features,
            input_is_packed=self.input_is_packed,
            max_fps=self.max_fps,
        )
        tree.delete_internal_nodes()
        if self.refinement == "none":
            to_fp, to_mols = tree._bf_to_np()
        else:
            to_fp, to_mols = tree._bf_to_np_refine(
                fp_file, initial_mol=start_idx,
                input_is_packed=self.input_is_packed,
            )
            if self.refinement == "full":
                tree.reset()
                tree.set_merge(
                    self.refine_merge_criterion,
                    tolerance=self.tolerance,
                    threshold=self.threshold + self.refine_threshold_change,
                )
                for bufs, mol_idxs in zip(to_fp.values(), to_mols.values()):
                    tree._fit_buffers(bufs, reinsert_index_seqs=mol_idxs)
                tree.delete_internal_nodes()
                to_fp, to_mols = tree._bf_to_np()
        _dump_round_buffers(self.out_dir, to_fp, to_mols, label, 1)


class _TreeMergingRound:
    r"""Worker: rebuild a tree from a bin of CF-buffer files, re-dump."""

    def __init__(
        self,
        branching_factor: int,
        threshold: float,
        tolerance: float,
        round_idx: int,
        out_dir: Path | str,
        split_largest_cluster: bool,
        criterion: str,
        all_fp_paths: tp.Sequence[Path] = (),
    ) -> None:
        self.branching_factor = branching_factor
        self.threshold = threshold
        self.tolerance = tolerance
        self.round_idx = round_idx
        self.out_dir = Path(out_dir)
        self.split_largest_cluster = split_largest_cluster
        self.criterion = criterion
        self.all_fp_paths = list(all_fp_paths)

    def _build_tree(
        self, pairs: tp.Sequence[tuple[Path, Path]]
    ) -> BitBirch:
        tree = BitBirch(
            branching_factor=self.branching_factor,
            threshold=self.threshold,
            merge_criterion=self.criterion,
            tolerance=self.tolerance,
        )
        for buf_path, idx_path in pairs:
            with open(idx_path, "rb") as f:
                mol_idxs = pickle.load(f)
            tree._fit_buffers(buf_path, reinsert_index_seqs=mol_idxs)
        return tree

    def __call__(
        self, batch: tuple[str, tp.Sequence[tuple[Path, Path]]]
    ) -> None:
        label, pairs = batch
        tree = self._build_tree(pairs)
        tree.delete_internal_nodes()
        if self.split_largest_cluster:
            to_fp, to_mols = tree._bf_to_np_refine(self.all_fp_paths)
        else:
            to_fp, to_mols = tree._bf_to_np()
        _dump_round_buffers(self.out_dir, to_fp, to_mols, label, self.round_idx)


class _FinalTreeMergingRound(_TreeMergingRound):
    r"""Final merge: one tree over all remaining buffers -> clusters.pkl."""

    def __init__(
        self,
        branching_factor: int,
        threshold: float,
        tolerance: float,
        criterion: str,
        out_dir: Path | str,
        save_tree: bool,
        save_centroids: bool,
    ) -> None:
        super().__init__(
            branching_factor, threshold, tolerance, -1, out_dir, False,
            criterion, (),
        )
        self.save_tree = save_tree
        self.save_centroids = save_centroids

    def __call__(
        self, batch: tuple[str, tp.Sequence[tuple[Path, Path]]]
    ) -> None:
        tree = self._build_tree(batch[1])
        if self.save_tree:
            tree.save(self.out_dir / "bitbirch.pkl")
        tree.delete_internal_nodes()
        if self.save_centroids:
            output = tree.get_centroids_mol_ids()
            with open(self.out_dir / "clusters.pkl", "wb") as f:
                pickle.dump(output["mol_ids"], f)
            with open(
                self.out_dir / "cluster-centroids-packed.pkl", "wb"
            ) as f:
                pickle.dump(output["centroids"], f)
        else:
            with open(self.out_dir / "clusters.pkl", "wb") as f:
                pickle.dump(tree.get_cluster_mol_ids(), f)


def run_multiround_bitbirch(
    input_files: tp.Sequence[Path],
    out_dir: Path,
    n_features: int | None = None,
    input_is_packed: bool = True,
    num_initial_processes: int = 10,
    num_midsection_processes: int | None = None,
    initial_merge_criterion: str = DEFAULTS.merge_criterion,
    branching_factor: int = DEFAULTS.branching_factor,
    threshold: float = DEFAULTS.threshold,
    midsection_threshold_change: float = DEFAULTS.refine_threshold_change,
    tolerance: float = DEFAULTS.tolerance,
    # Advanced
    num_midsection_rounds: int = 1,
    bin_size: int = 10,
    max_tasks_per_process: int = 1,
    refinement_before_midsection: str = "full",
    split_largest_after_each_midsection_round: bool = False,
    midsection_merge_criterion: str = DEFAULTS.refine_merge_criterion,
    final_merge_criterion: str | None = None,
    mp_context: tp.Any = None,
    save_tree: bool = False,
    save_centroids: bool = True,
    # Debug
    max_fps: int | None = None,
    verbose: bool = False,
    cleanup: bool = True,
) -> Timer:
    r"""Run the full multi-round clustering pipeline; returns the Timer.

    Parallel and serial (``num_initial_processes=1``) execution produce
    identical clusters, as in the reference.
    """
    out_dir = Path(out_dir)
    if final_merge_criterion is None:
        final_merge_criterion = midsection_merge_criterion
    if mp_context is None:
        mp_context = mp.get_context(
            "forkserver" if sys.platform == "linux" else None
        )
    console = get_console(silent=not verbose)
    if num_midsection_processes is None:
        num_midsection_processes = num_initial_processes
    elif num_midsection_processes > num_initial_processes:
        raise ValueError("Num. midsection procs. must be <= num. initial processes")

    common = dict(
        branching_factor=branching_factor,
        tolerance=tolerance,
        out_dir=out_dir,
    )
    timer = Timer()
    timer.init_timing("total")

    shards = _shard_index_ranges(input_files)

    # -- Round 1: per-shard tree builds --------------------------------------
    round_idx = 1
    timer.init_timing(f"round-{round_idx}")
    console.print(f"Round {round_idx} (initial): clustering the fingerprint shards")
    initial_fn = _InitialRound(
        n_features=n_features,
        refinement_before_midsection=refinement_before_midsection,
        max_fps=max_fps,
        merge_criterion=initial_merge_criterion,
        input_is_packed=input_is_packed,
        threshold=threshold,
        refine_merge_criterion=midsection_merge_criterion,
        refine_threshold_change=midsection_threshold_change,
        **common,
    )
    num_ps = min(num_initial_processes, len(shards))
    console.print(f"    - Processing {len(shards)} inputs with {num_ps} processes")
    if num_ps == 1:
        for shard in shards:
            initial_fn(shard)
    else:
        with mp_context.Pool(
            processes=num_ps, maxtasksperchild=max_tasks_per_process
        ) as pool:
            pool.map(initial_fn, shards)
    timer.end_timing(f"round-{round_idx}", console)
    console.print_peak_mem(out_dir)

    # -- Midsection rounds: binned tree merges -------------------------------
    for _ in range(num_midsection_rounds):
        round_idx += 1
        timer.init_timing(f"round-{round_idx}")
        console.print(f"Round {round_idx} (midsection): merging CF buffers in bins")
        pairs = _collect_round_file_pairs(out_dir, round_idx, console)
        bins = _bin_file_pairs(pairs, bin_size, console)
        merging_fn = _TreeMergingRound(
            round_idx=round_idx,
            all_fp_paths=input_files,
            split_largest_cluster=split_largest_after_each_midsection_round,
            criterion=midsection_merge_criterion,
            threshold=threshold + midsection_threshold_change,
            **common,
        )
        num_ps = min(num_midsection_processes, len(bins))
        console.print(f"    - Processing {len(bins)} inputs with {num_ps} processes")
        if num_ps == 1:
            for b in bins:
                merging_fn(b)
        else:
            with mp_context.Pool(
                processes=num_ps, maxtasksperchild=max_tasks_per_process
            ) as pool:
                pool.map(merging_fn, bins)
        timer.end_timing(f"round-{round_idx}", console)
        console.print_peak_mem(out_dir)

    # -- Final round ----------------------------------------------------------
    round_idx += 1
    timer.init_timing(f"round-{round_idx}")
    console.print(f"Round {round_idx} (final): merging the remaining buffers")
    pairs = _collect_round_file_pairs(out_dir, round_idx, console)
    final_fn = _FinalTreeMergingRound(
        save_tree=save_tree,
        save_centroids=save_centroids,
        criterion=final_merge_criterion,
        threshold=threshold + midsection_threshold_change,
        **common,
    )
    final_fn(("", pairs))
    timer.end_timing(f"round-{round_idx}", console)
    console.print_peak_mem(out_dir)

    if cleanup:
        for f in out_dir.glob("round-*.npy"):
            f.unlink()
        for f in out_dir.glob("round-*.pkl"):
            f.unlink()
    console.print()
    timer.end_timing("total", console, indent=False)
    return timer
