r"""Device half of ``bb run``: the batch and sharded engines over ``.npy`` files.

``bb run --engine batch|sharded`` and ``chip_smoke.py`` both call
:func:`run_batch_engine` / :func:`run_sharded_engine`.  The module imports
nothing beyond numpy, jax and this package (no click, rich or psutil), so the
device path runs wherever JAX does.  The console argument only needs
``print(msg)`` and a ``status(msg)`` context manager; :class:`PlainConsole`
is the dependency-free default.
"""

from __future__ import annotations

import contextlib
import pickle
import typing as tp
from pathlib import Path

import numpy as np

from bblean_tpu._timer import Timer

__all__ = ["PlainConsole", "run_batch_engine", "run_sharded_engine"]


class PlainConsole:
    r"""Line-printing console (``print`` + ``status``) without rich."""

    def __init__(self, silent: bool = False) -> None:
        self.silent = silent

    def print(self, *args: tp.Any, **_kwargs: tp.Any) -> None:
        if not self.silent:
            print(*args, flush=True)

    def status(self, msg: str, **_kwargs: tp.Any) -> tp.ContextManager:
        self.print(msg)
        return contextlib.nullcontext()


def _total_rows(input_files: tp.Sequence[Path], max_fps: int | None) -> int:
    from bblean_tpu.fingerprints import _get_fps_file_num

    total = 0
    for file in input_files:
        n = _get_fps_file_num(file)
        total += min(n, max_fps) if max_fps is not None else n
    return total


def _load_packed(file: Path, max_fps: int | None, input_is_packed: bool):
    from bblean_tpu.fingerprints import pack_fingerprints

    fps = np.load(file, mmap_mode="r")[:max_fps]
    if not input_is_packed:
        fps = pack_fingerprints(np.asarray(fps, dtype=np.uint8))
    return fps


def run_sharded_engine(
    input_files, out_dir, config, console=None, timer=None, *, threshold,
    merge_criterion, tolerance, n_features, input_is_packed, max_fps,
    save_centroids, batch_size=8192, refine_num=0, refine_rounds=0,
    refine_merge_criterion=None, refine_threshold_change=0.0,
    recluster_rounds=0, recluster_shuffle=False,
) -> None:
    r"""SPMD path of ``bb run``: data-parallel over every visible device.

    The merge-reduction rounds use the refine criterion/threshold-change
    options, mirroring multiround's midsection parameters.  Refinement
    (``--refine-num``) explodes the largest merged clusters into singleton
    rows re-sharded over the mesh and re-fits + re-merges (reference flow
    ``bblean/bitbirch.py:1187-1214``, ``cli.py:1076-1095``).
    """
    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()

    from bblean_tpu.parallel import ShardedForest, get_mesh

    console = console if console is not None else PlainConsole()
    timer = timer if timer is not None else Timer()
    mesh = get_mesh()
    console.print(f"Sharding over {mesh.devices.size} device(s)")

    # Stream file-by-file through the forest: windows are materialized from
    # the memmap one at a time, so host RSS stays bounded at any input size
    total_rows = _total_rows(input_files, max_fps)

    # Clamp the device batch to the input: compile cost scales with the
    # program's row-block shape, so an 8192-row batch on a 600-row input
    # burns minutes of XLA compile (on CPU meshes) for slots that never
    # hold a row.  One window per device still covers the whole input.
    if total_rows:
        per_dev = -(-total_rows // mesh.devices.size)
        batch_size = max(64, min(batch_size, 1 << (per_dev - 1).bit_length()))

    forest: ShardedForest | None = None
    timer.init_timing("fit")
    with console.status("BitBirching (SPMD)...", spinner="dots"):
        for file in input_files:
            fps = _load_packed(file, max_fps, input_is_packed)
            if forest is None:
                feats = n_features if n_features is not None else fps.shape[1] * 8
                forest = ShardedForest(
                    feats,
                    mesh,
                    threshold=threshold,
                    merge_criterion=merge_criterion,
                    tolerance=tolerance,
                    merge_criterion_merge=refine_merge_criterion,
                    merge_threshold_change=refine_threshold_change,
                    batch_size=batch_size,
                    # Shrink the scan window so small inputs do not pay the
                    # full 16-batch window's group-table headroom (same
                    # clamp as parallel.sharded_fit)
                    scan_batches=max(
                        1,
                        min(
                            16,
                            -(
                                -total_rows
                                // (mesh.devices.size * batch_size)
                            ),
                        ),
                    ),
                    # Sized to the input (capacity grows on demand per merge
                    # round): a floor at thousands of rows would make every
                    # capacity-shaped device op pay for table slots a small
                    # run never uses — measured as ~30 min of merge wall for
                    # a 600-row input on the virtual 8-device CPU mesh
                    initial_capacity=max(
                        2 * batch_size + 2,
                        min(
                            total_rows + batch_size + 1,
                            (total_rows // mesh.devices.size) * 2
                            + 2 * batch_size,
                        ),
                    ),
                )
            forest.fit_packed(fps)
    if forest is None:
        raise ValueError("no input files")
    timer.end_timing("fit", console)
    timer.init_timing("merge")
    with console.status("Merging shards...", spinner="dots"):
        forest.merge()
    timer.end_timing("merge", console)

    for r in range(refine_rounds):
        with console.status(
            f"Refinement, round {r + 1} (SPMD)...", spinner="dots"
        ):
            forest.refine_inplace(
                input_files if len(input_files) > 1 else input_files[0],
                input_is_packed=input_is_packed,
                n_largest=refine_num,
                threshold=threshold + refine_threshold_change,
                merge_criterion=refine_merge_criterion,
                tolerance=tolerance,
                # The refined threshold already carries the delta; zero the
                # stored fit->merge change so the reduction rounds run at
                # threshold + change, not threshold + 2 * change
                merge_threshold_change=0.0,
            )
    for r in range(recluster_rounds):
        with console.status(
            f"Reclustering, round {r + 1} (SPMD)...", spinner="dots"
        ):
            forest.recluster_inplace(shuffle=recluster_shuffle)

    labels = forest.labels()
    sizes = forest.cluster_sizes()
    num_clusters = forest.num_clusters
    # Clusters sorted by size desc (stable), like the other engines
    order = np.argsort(-sizes, kind="stable")
    sort_idx = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(
        labels[sort_idx], np.arange(num_clusters + 1)
    ).tolist()
    flat = sort_idx.tolist()
    inv = [flat[bounds[i] : bounds[i + 1]] for i in order]
    with open(Path(out_dir) / "clusters.pkl", "wb") as f:
        pickle.dump(inv, f)
    if save_centroids:
        from bblean_tpu._np_similarity import centroid_from_sum

        linear_sums = forest.linear_sums()
        cents = [
            centroid_from_sum(
                linear_sums[i].astype(np.uint64), int(sizes[i]), pack=True
            )
            for i in order
        ]
        with open(Path(out_dir) / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump(cents, f)
    config["n_clusters"] = int(num_clusters)
    config["n_devices"] = int(mesh.devices.size)
    config["device_table_bytes_per_device"] = forest.state_bytes_per_device()


def run_batch_engine(
    input_files, out_dir, config, console=None, timer=None, *, threshold,
    merge_criterion, tolerance, n_features, input_is_packed, max_fps,
    save_centroids, batch_size=8192, fanout=None, refine_num=0,
    refine_rounds=0, refine_merge_criterion=None,
    refine_threshold_change=0.0, recluster_rounds=0,
    recluster_shuffle=False,
) -> None:
    r"""Device path of ``bb run``: the batched engine on the accelerator,
    with inputs streamed from host memory."""
    from bblean_tpu._jax_cache import enable_persistent_cache

    enable_persistent_cache()
    from bblean_tpu.engine.batch import BatchTree

    console = console if console is not None else PlainConsole()
    timer = timer if timer is not None else Timer()
    # Pre-size the device tables from the total input row count (read from
    # the .npy headers, nothing loaded): avoids up to ~11 growth recompiles
    # on a 10M-row input.  Clusters can never exceed rows.
    total_rows = _total_rows(input_files, max_fps)
    capacity = max(8192, total_rows + batch_size + 1)
    tile = None
    if fanout is None:
        # Reference guidance scaled to the tiled layout: larger groups at
        # very large scale keep the routing table (and its matmul) small.
        # An explicit --fanout always wins over this auto-tune.
        fanout, tile = (384, 512) if total_rows > 2_000_000 else (192, None)
        console.print(
            f"Auto-tuned fanout={fanout}"
            + (f", tile={tile}" if tile is not None else "")
            + f" for {total_rows} rows"
        )

    tree: BatchTree | None = None
    offset = 0
    timer.init_timing("fit")
    with console.status("BitBirching (device)...", spinner="dots"):
        for file in input_files:
            fps = _load_packed(file, max_fps, input_is_packed)
            if tree is None:
                feats = n_features if n_features is not None else fps.shape[1] * 8
                tree = BatchTree(
                    feats,
                    threshold=threshold,
                    merge_criterion=merge_criterion,
                    tolerance=tolerance,
                    batch_size=batch_size,
                    fanout=fanout,
                    **({"tile": tile} if tile is not None else {}),
                    initial_capacity=capacity,
                )
            tree.fit_packed(np.asarray(fps), range(offset, offset + len(fps)))
            offset += len(fps)
    if tree is None:
        raise ValueError("no input files")
    timer.end_timing("fit", console)
    for r in range(refine_rounds):
        with console.status(
            f"Refinement, round {r + 1} (device)...", spinner="dots"
        ):
            tree.refine_inplace(
                input_files if len(input_files) > 1 else input_files[0],
                input_is_packed=input_is_packed,
                n_largest=refine_num,
                threshold=threshold + refine_threshold_change,
                merge_criterion=refine_merge_criterion,
                tolerance=tolerance,
            )
    for r in range(recluster_rounds):
        with console.status(
            f"Reclustering, round {r + 1} (device)...", spinner="dots"
        ):
            tree.recluster_inplace(shuffle=recluster_shuffle)
    # Sort clusters by size desc (stable), as the exact engine does
    timer.init_timing("extract")
    sizes = tree.cluster_sizes()
    mols = tree.cluster_mols()
    order = np.argsort(-sizes, kind="stable")
    with open(Path(out_dir) / "clusters.pkl", "wb") as f:
        pickle.dump([mols[i] for i in order], f)
    if save_centroids:
        cents = tree.packed_centroids()
        with open(Path(out_dir) / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump([cents[i] for i in order], f)
    timer.end_timing("extract", console)
    config["n_clusters"] = int(len(sizes))
