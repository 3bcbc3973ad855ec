r"""Public ``BitBirch`` estimator.

API-compatible with the reference ``bblean.bitbirch.BitBirch``
(``bblean/bitbirch.py:539-1425``): same constructor parameters and defaults,
same ``fit`` / extraction / refinement / persistence surface, same cluster
labels (the default engine is the bit-exact serial-equivalent
``bblean_tpu.engine.exact.ExactTree``).

Differences by design:

- The tree state is flat (id-indexed pools) rather than a recursive object
  graph, so ``save``/``load`` need no recursion-limit manipulation.
- The insert loop runs in the native C++ engine when built
  (``bblean_tpu.engine.native``; disable with ``BBLEAN_TPU_NO_EXTENSIONS=1``)
  — bit-identical labels either way.
- The batched device engine is a separate class
  (``bblean_tpu.engine.batch.BatchTree``; ``bb run --engine batch``): it
  trades bit-exact label parity for device-scale throughput.
"""

from __future__ import annotations

import pickle
import random
import typing as tp
import warnings
from collections import defaultdict
from pathlib import Path
from weakref import WeakSet

import numpy as np
from numpy.typing import NDArray

from bblean_tpu._memory import _ArrayMemPagesManager, _mmap_file_and_madvise_sequential
from bblean_tpu._merges import BUILTIN_MERGES, MergeAcceptFunction, get_merge_accept_fn
from bblean_tpu._np_similarity import jt_isim_medoid
from bblean_tpu.engine.exact import ExactTree
from bblean_tpu.fingerprints import (
    _get_fingerprints_from_file_seq,
    pack_fingerprints,
    unpack_fingerprints,
)

__all__ = ["BitBirch", "set_merge"]

_Input = tp.Union[NDArray[np.integer], tp.List[NDArray[np.integer]]]

# Registry for the (discouraged) global set_merge, kept for API parity
_BITBIRCH_INSTANCES: "WeakSet[BitBirch]" = WeakSet()
_global_merge_accept: MergeAcceptFunction | None = None

_UNPACK_CHUNK = 4096


def _native_engine_enabled() -> bool:
    from bblean_tpu.utils import extensions_disabled_by_env

    if extensions_disabled_by_env():
        return False
    try:
        from bblean_tpu.engine.native import native_engine_available

        return native_engine_available()
    except (ImportError, OSError):
        return False


def set_merge(merge_criterion: str, tolerance: float = 0.05) -> None:
    r"""Set the merge criterion globally for every BitBirch instance.

    Deprecated surface kept for reference compatibility; prefer
    ``BitBirch(..., merge_criterion=...)`` or ``tree.set_merge(...)``.
    """
    msg = (
        "Use of the global `set_merge` function is highly discouraged,\n"
        " instead use either: "
        " bb_tree = BitBirch(...)\n"
        " bb_tree.set_merge(merge_criterion=..., tolerance=...)\n"
        " or directly: `bb_tree = BitBirch(..., merge_criterion=..., tolerance=...)`."
    )
    warnings.warn(msg, UserWarning)
    global _global_merge_accept
    _global_merge_accept = get_merge_accept_fn(merge_criterion, tolerance)
    for tree in _BITBIRCH_INSTANCES:
        tree._merge_accept_fn = _global_merge_accept


def _validate_n_features(
    X: _Input, input_is_packed: bool, n_features: int | None = None
) -> int:
    if len(X) == 0:
        raise ValueError("Input must have at least 1 fingerprint")
    row_len = len(X[0]) if isinstance(X, list) else X.shape[1]
    if input_is_packed:
        padded = row_len * 8
        if n_features is None:
            return padded
        if padded < n_features:
            raise ValueError(
                "n_features is larger than the padded length, which is inconsistent"
            )
        return n_features
    if n_features is not None and n_features != row_len:
        raise ValueError(
            "n_features is redundant for non-packed inputs;"
            " if passed, it must be equal to X.shape[1] (or len(X[0]))."
            f" For passed X the inferred n_features was {row_len}."
        )
    return row_len


class _CentroidsMolIds(tp.TypedDict):
    centroids: list[NDArray[np.uint8]]
    mol_ids: list[list[int]]


class _MedoidsMolIds(tp.TypedDict):
    medoids: NDArray[np.uint8]
    mol_ids: list[list[int]]


class BitBirch:
    r"""BitBIRCH clustering estimator (exact host engine).

    Parameters mirror the reference: ``threshold`` (similarity acceptance
    level, default 0.65), ``branching_factor`` (max subclusters per node,
    default 50), ``merge_criterion`` (one of
    radius|diameter|tolerance-diameter|tolerance-radius|tolerance-legacy|
    never-merge, default "diameter"), ``tolerance`` (for tolerance criteria).
    """

    def __init__(
        self,
        *,
        threshold: float = 0.65,
        branching_factor: int = 50,
        merge_criterion: str | MergeAcceptFunction | None = None,
        tolerance: float | None = None,
    ):
        self.threshold = threshold
        self.branching_factor = branching_factor
        if _global_merge_accept is not None:
            if tolerance is not None:
                raise ValueError(
                    "tolerance can only be passed if "
                    "the *global* set_merge function has *not* been used"
                )
            if merge_criterion is not None:
                raise ValueError(
                    "merge_criterion can only be passed if "
                    "the *global* set_merge function has *not* been used"
                )
            self._merge_accept_fn = _global_merge_accept
        elif isinstance(merge_criterion, MergeAcceptFunction):
            self._merge_accept_fn = merge_criterion
        else:
            self._merge_accept_fn = get_merge_accept_fn(
                "diameter" if merge_criterion is None else merge_criterion,
                0.05 if tolerance is None else tolerance,
            )

        self._num_fitted_fps = 0
        self._engine: ExactTree | None = None
        self._internal_nodes_dropped = False
        self._global_clustering_centroid_labels: NDArray[np.int64] | None = None
        self._n_global_clusters = 0
        _BITBIRCH_INSTANCES.add(self)

    # -- properties ----------------------------------------------------------

    @property
    def merge_criterion(self) -> str:
        return self._merge_accept_fn.name

    @merge_criterion.setter
    def merge_criterion(self, value: str) -> None:
        self.set_merge(criterion=value)

    @property
    def tolerance(self) -> float | None:
        return getattr(self._merge_accept_fn, "tolerance", None)

    @tolerance.setter
    def tolerance(self, value: float) -> None:
        self.set_merge(tolerance=value)

    @property
    def is_init(self) -> bool:
        r"""True once the tree holds leaves (after the first ``fit``)."""
        return self._engine is not None and self._engine.is_init

    @property
    def num_fitted_fps(self) -> int:
        r"""Total number of fitted fingerprints."""
        return self._num_fitted_fps

    @property
    def _only_has_leaves(self) -> bool:
        return self._internal_nodes_dropped and self.is_init

    def set_merge(
        self,
        criterion: str | MergeAcceptFunction | None = None,
        *,
        tolerance: float | None = None,
        threshold: float | None = None,
        branching_factor: int | None = None,
    ) -> None:
        r"""Change merge criterion / threshold / branching for future inserts."""
        if _global_merge_accept is not None:
            raise ValueError(
                "BitBirch.set_merge() can only called if "
                "the global set_merge() function has *not* been used"
            )
        _tolerance = 0.05 if tolerance is None else tolerance
        if isinstance(criterion, MergeAcceptFunction):
            self._merge_accept_fn = criterion
        elif isinstance(criterion, str):
            self._merge_accept_fn = get_merge_accept_fn(criterion, _tolerance)
        if hasattr(self._merge_accept_fn, "tolerance"):
            self._merge_accept_fn.tolerance = _tolerance
        elif tolerance is not None:
            raise ValueError(f"Can't set tolerance for {self._merge_accept_fn}")
        if threshold is not None:
            self.threshold = threshold
        if branching_factor is not None:
            self.branching_factor = branching_factor

    # -- fitting -------------------------------------------------------------

    def _ensure_engine(self, n_features: int) -> ExactTree:
        if self._only_has_leaves:
            raise ValueError("Internal nodes were released, call reset() before fit()")
        if self._engine is None:
            if _native_engine_enabled() and (
                self._merge_accept_fn.name in BUILTIN_MERGES
            ):
                from bblean_tpu.engine.native import NativeExactTree

                self._engine = NativeExactTree(self.branching_factor, n_features)
            else:
                self._engine = ExactTree(self.branching_factor, n_features)
        if not self._engine.is_init:
            self._engine.init_root()
        return self._engine

    def _sync_native_criterion(self, engine: tp.Any) -> bool:
        r"""Point a native engine at the current criterion; True if native."""
        if not hasattr(engine, "set_criterion"):
            return False
        name = self._merge_accept_fn.name
        if name not in BUILTIN_MERGES:
            raise ValueError(
                "The native engine cannot evaluate custom merge functions;"
                " set BBLEAN_TPU_NO_EXTENSIONS=1 to use the Python engine"
            )
        tolerance = getattr(self._merge_accept_fn, "tolerance", 0.05)
        engine.set_criterion(name, self.threshold, tolerance)
        return True

    def fit(
        self,
        X: _Input | Path | str,
        /,
        reinsert_indices: tp.Iterable[int] | None = None,
        input_is_packed: bool = True,
        n_features: int | None = None,
        max_fps: int | None = None,
    ) -> "BitBirch":
        r"""Insert fingerprints (packed array, unpacked array, list of rows, or
        a ``.npy`` path) into the tree.

        ``reinsert_indices`` supplies the global molecule index of each row
        (used by sharded/multiround workflows); by default rows continue from
        ``num_fitted_fps``.
        """
        if isinstance(X, (Path, str)):
            X = _mmap_file_and_madvise_sequential(Path(X), max_fps=max_fps)
            mmanager = _ArrayMemPagesManager.from_bb_input(X)
        else:
            X = X[:max_fps]
            mmanager = _ArrayMemPagesManager.from_bb_input(X, can_release=False)

        n_features = _validate_n_features(X, input_is_packed, n_features)
        engine = self._ensure_engine(n_features)
        accept_fn = self._merge_accept_fn
        threshold = self.threshold

        if reinsert_indices is None:
            idx_iter: tp.Iterator[int] = iter(range(self._num_fitted_fps, 1 << 62))
        else:
            idx_iter = iter(reinsert_indices)

        is_native = self._sync_native_criterion(engine)
        num_rows = len(X)
        consumed = 0
        for start in range(0, num_rows, _UNPACK_CHUNK):
            stop = min(start + _UNPACK_CHUNK, num_rows)
            if isinstance(X, list):
                chunk = np.stack([np.asarray(r) for r in X[start:stop]])
            else:
                chunk = np.asarray(X[start:stop])
            if input_is_packed:
                packed = chunk
                unpacked = None
            else:
                unpacked = chunk.astype(np.uint8, copy=False)
                packed = pack_fingerprints(unpacked)
            if is_native:
                # Whole chunk in one native call (no per-row dispatch)
                idxs = np.fromiter(
                    (next(idx_iter) for _ in range(stop - start)),
                    dtype=np.int64,
                    count=stop - start,
                )
                engine.insert_packed_chunk(packed, idxs)
                self._num_fitted_fps += stop - start
                consumed += stop - start
            else:
                if unpacked is None:
                    unpacked = unpack_fingerprints(chunk, n_features)
                for row in range(stop - start):
                    engine.insert_fp(
                        unpacked[row],
                        packed[row].copy(),
                        next(idx_iter),
                        accept_fn,
                        threshold,
                    )
                    self._num_fitted_fps += 1
                    consumed += 1
                    if mmanager.can_release and mmanager.should_release_curr_page(
                        consumed
                    ):
                        mmanager.release_curr_page_and_update_addr()
            if (
                is_native
                and mmanager.can_release
                and mmanager.should_release_curr_page(consumed)
            ):
                mmanager.release_curr_page_and_update_addr()
        return self

    def _fit_buffers(
        self,
        X: _Input | Path | str,
        reinsert_index_seqs: (
            tp.Iterable[tp.Sequence[int]] | tp.Literal["omit"]
        ) = "omit",
    ) -> "BitBirch":
        r"""Insert pre-aggregated CF buffers ``[linear_sum..., n_samples]``.

        This is the canonical re-insertion path for refinement and for the
        multiround/sharded CF exchange (reference ``bitbirch.py:790-866``).
        """
        if isinstance(X, (Path, str)):
            X = _mmap_file_and_madvise_sequential(Path(X))
        n_features = _validate_n_features(X, input_is_packed=False) - 1
        engine = self._ensure_engine(n_features)
        accept_fn = self._merge_accept_fn
        threshold = self.threshold

        idx_provider: tp.Iterable[tp.Sequence[int]]
        if reinsert_index_seqs == "omit":
            idx_provider = (() for _ in range(self._num_fitted_fps))
            check = False
        else:
            idx_provider = reinsert_index_seqs
            check = True
        is_native = self._sync_native_criterion(engine)
        if is_native:
            bufs: list[np.ndarray] = []
            mol_lists: list[list[int]] = []
            for idxs, buf in zip(idx_provider, X):
                buf = np.asarray(buf)
                if check and len(idxs) != int(buf[-1]):
                    raise ValueError(
                        "Expected len(mol_indices) == buffer[-1],"
                        f" but found {len(idxs)} != {buf[-1]}"
                    )
                bufs.append(buf)
                mol_lists.append(list(idxs))
                self._num_fitted_fps += len(idxs)
            if bufs:
                engine.insert_buffer_group(
                    bufs, mol_lists, np.dtype(bufs[0].dtype).itemsize
                )
            return self
        for idxs, buf in zip(idx_provider, X):
            buf = np.asarray(buf)
            if check and len(idxs) != int(buf[-1]):
                raise ValueError(
                    "Expected len(mol_indices) == buffer[-1],"
                    f" but found {len(idxs)} != {buf[-1]}"
                )
            engine.insert_buffer(buf, list(idxs), accept_fn, threshold)
            self._num_fitted_fps += len(idxs)
        return self

    def fit_reinsert(
        self,
        X: _Input | Path | str,
        reinsert_indices: tp.Iterable[int],
        input_is_packed: bool = True,
        n_features: int | None = None,
        max_fps: int | None = None,
    ) -> "BitBirch":
        r""":meta private:"""
        return self.fit(X, reinsert_indices, input_is_packed, n_features, max_fps)

    # -- extraction ----------------------------------------------------------

    def _require_engine(self) -> ExactTree:
        if self._engine is None or not self._engine.is_init:
            raise ValueError("The model has not been fitted yet.")
        return self._engine

    def _get_leaf_bfs(self, sort: bool = True) -> list[int]:
        r"""Leaf subcluster ids (stable-sorted by size desc when ``sort``)."""
        return self._require_engine().leaf_sub_ids(sort=sort)

    def get_centroids_mol_ids(
        self, sort: bool = True, packed: bool = True
    ) -> _CentroidsMolIds:
        r"""Dict with the centroid and molecule indices of every cluster."""
        engine = self._require_engine()
        centroids = []
        mol_ids = []
        for sid in engine.leaf_sub_ids(sort=sort):
            cent = engine.sub_packed_centroid(sid)
            if not packed:
                cent = unpack_fingerprints(cent, engine.n_features)
            centroids.append(cent)
            mol_ids.append(engine.sub_mols(sid))
        return {"centroids": centroids, "mol_ids": mol_ids}

    def get_centroids(
        self, sort: bool = True, packed: bool = True
    ) -> list[NDArray[np.uint8]]:
        r"""List of cluster centroid fingerprints."""
        return self.get_centroids_mol_ids(sort=sort, packed=packed)["centroids"]

    def get_cluster_mol_ids(
        self, sort: bool = True, global_clusters: bool = False
    ) -> list[list[int]]:
        r"""Molecule indices of each cluster (largest clusters first)."""
        engine = self._require_engine()
        if global_clusters:
            if self._global_clustering_centroid_labels is None:
                raise ValueError(
                    "Must perform global clustering before fetching global labels"
                )
            labels = self._global_clustering_centroid_labels - 1
            it = (engine.sub_mols(s) for s in engine.leaf_sub_ids(sort=sort))
            return self._new_ids_from_labels(it, labels, self._n_global_clusters)
        return [engine.sub_mols(s) for s in engine.leaf_sub_ids(sort=sort)]

    @staticmethod
    def _new_ids_from_labels(
        members: tp.Iterable[list[int]],
        labels: NDArray[np.int64],
        n_labels: int | None = None,
    ) -> list[list[int]]:
        if n_labels is None:
            n_labels = len(np.unique(labels))
        out: list[list[int]] = [[] for _ in range(n_labels)]
        for i, idxs in enumerate(members):
            out[labels[i]].extend(idxs)
        return out

    def get_medoids_mol_ids(
        self,
        fps: NDArray[np.uint8],
        sort: bool = True,
        pack: bool = True,
        global_clusters: bool = False,
        input_is_packed: bool = True,
        n_features: int | None = None,
    ) -> _MedoidsMolIds:
        r"""Dict with the medoid fingerprint and molecule ids of each cluster."""
        members = self.get_cluster_mol_ids(sort=sort, global_clusters=global_clusters)
        if input_is_packed:
            fps = unpack_fingerprints(fps, n_features=n_features)
        medoids = np.zeros((len(members), fps.shape[1]), dtype=np.uint8)
        for i, mols in enumerate(members):
            medoids[i, :] = jt_isim_medoid(
                fps[mols], input_is_packed=False, pack=False
            )[1]
        if pack:
            medoids = pack_fingerprints(medoids)
        return {"medoids": medoids, "mol_ids": members}

    def get_medoids(
        self,
        fps: NDArray[np.uint8],
        sort: bool = True,
        pack: bool = True,
        global_clusters: bool = False,
        input_is_packed: bool = True,
        n_features: int | None = None,
    ) -> NDArray[np.uint8]:
        r"""Medoid fingerprint of each cluster."""
        return self.get_medoids_mol_ids(
            fps, sort, pack, global_clusters, input_is_packed, n_features
        )["medoids"]

    def get_assignments(
        self,
        n_mols: int | None = None,
        sort: bool = True,
        check_valid: bool = True,
        global_clusters: bool = False,
    ) -> NDArray[np.uint64]:
        r"""Per-molecule cluster labels (1-based; 0 marks unassigned)."""
        if n_mols is not None:
            warnings.warn("The n_mols argument is redundant", DeprecationWarning)
            if n_mols != self.num_fitted_fps:
                raise ValueError(
                    f"Provided n_mols {n_mols} is different"
                    f" from the number of fitted fingerprints {self.num_fitted_fps}"
                )
        if check_valid:
            assignments = np.full(self.num_fitted_fps, 0, dtype=np.uint64)
        else:
            assignments = np.empty(self.num_fitted_fps, dtype=np.uint64)

        engine = self._require_engine()
        if sort:
            iterator: tp.Iterable[list[int]] = (
                engine.sub_mols(s) for s in engine.leaf_sub_ids(sort=True)
            )
        else:
            iterator = (engine.sub_mols(s) for s in engine.leaf_sub_ids(sort=False))

        if global_clusters:
            if self._global_clustering_centroid_labels is None:
                raise ValueError(
                    "Must perform global clustering before fetching global labels"
                )
            for mols, label in zip(iterator, self._global_clustering_centroid_labels):
                assignments[mols] = label
        else:
            for i, mols in enumerate(iterator, 1):
                assignments[mols] = i
        if check_valid and (assignments == 0).any():
            raise ValueError("There are unasigned molecules")
        return assignments

    def dump_assignments(
        self,
        path: Path | str,
        smiles: tp.Iterable[str] = (),
        sort: bool = True,
        global_clusters: bool = False,
        check_valid: bool = True,
    ) -> None:
        r"""Dump cluster assignments (and optional SMILES) to a CSV file."""
        import pandas as pd  # Deferred: pandas import is heavy

        if isinstance(smiles, str):
            smiles = [smiles]
        smiles_arr = np.asarray(list(smiles), dtype=np.str_)
        assignments = self.get_assignments(
            sort=sort, check_valid=check_valid, global_clusters=global_clusters
        )
        if smiles_arr.size and len(assignments) != len(smiles_arr):
            raise ValueError(
                f"Len of the provided smiles {len(smiles_arr)}"
                f" must match the number of fitted fingerprints {self.num_fitted_fps}"
            )
        df = pd.DataFrame({"assignments": assignments})
        if smiles_arr.size:
            df["smiles"] = smiles_arr
        df.to_csv(Path(path), index=False)

    # -- memory / lifecycle --------------------------------------------------

    def reset(self) -> None:
        r"""Drop the whole tree (does not reset merge parameters)."""
        self._engine = None
        self._internal_nodes_dropped = False
        self._num_fitted_fps = 0

    def delete_internal_nodes(self) -> None:
        r"""Release internal nodes, keeping leaf clusters readable only."""
        engine = self._require_engine()
        if not engine.root_is_leaf:
            engine.drop_internal_nodes()
            self._internal_nodes_dropped = True

    # -- refinement ----------------------------------------------------------

    def _prepare_bf_to_buffer_dicts(
        self, sids: list[int]
    ) -> tuple[dict[str, list[NDArray[np.integer]]], dict[str, list[list[int]]]]:
        engine = self._require_engine()
        to_fp: dict[str, list[NDArray[np.integer]]] = defaultdict(list)
        to_mols: dict[str, list[list[int]]] = defaultdict(list)
        for sid in sids:
            name = engine.sub_dtype_name(sid)
            to_fp[name].append(engine.sub_buffer(sid))
            to_mols[name].append(engine.sub_mols(sid))
        return to_fp, to_mols

    def _bf_to_np(
        self,
    ) -> tuple[dict[str, list[NDArray[np.integer]]], dict[str, list[list[int]]]]:
        r"""CF buffers + molecule ids of all clusters, grouped by dtype class."""
        return self._prepare_bf_to_buffer_dicts(self._get_leaf_bfs())

    def _bf_to_np_refine(
        self,
        X: _Input | Path | str | tp.Sequence[Path],
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
    ) -> tuple[dict[str, list[NDArray[np.integer]]], dict[str, list[list[int]]]]:
        r"""CF buffers with the ``n_largest`` clusters exploded to singletons.

        Requires the original fingerprints (array, ``.npy`` path, or sequence
        of paths) to rebuild the singleton rows of the exploded clusters.
        """
        if n_largest == 0:
            return self._bf_to_np()
        if n_largest < 1:
            raise ValueError("n_largest must be >= 1")

        engine = self._require_engine()
        sids = self._get_leaf_bfs()
        largest, rest = sids[:n_largest], sids[n_largest:]
        n_features = engine.n_features

        to_fp, to_mols = self._prepare_bf_to_buffer_dicts(rest)
        for big in largest:
            big_mols = engine.sub_mols(big)
            arr_idxs_full = [(idx - initial_mol) for idx in big_mols]
            if isinstance(X, (Path, str)):
                rows = np.load(X, mmap_mode="r")[arr_idxs_full]
                arr_idxs = list(range(len(rows)))
                mol_idxs = big_mols
            elif len(X) and isinstance(X[0], Path):
                order = np.argsort(arr_idxs_full)
                rows = _get_fingerprints_from_file_seq(
                    tp.cast(tp.Sequence[Path], X),
                    [arr_idxs_full[i] for i in order],
                )
                arr_idxs = list(range(len(rows)))
                mol_idxs = [big_mols[i] for i in order]
            else:
                rows = tp.cast(_Input, X)
                arr_idxs = arr_idxs_full
                mol_idxs = big_mols
            for mol_idx, arr_idx in zip(mol_idxs, arr_idxs):
                buffer = np.empty(n_features + 1, dtype=np.uint8)
                row = np.asarray(rows[arr_idx])
                if input_is_packed:
                    buffer[:-1] = unpack_fingerprints(row, n_features)
                else:
                    buffer[:-1] = row
                buffer[-1] = 1
                to_fp["uint8"].append(buffer)
                to_mols["uint8"].append([mol_idx])
        return to_fp, to_mols

    def refine_inplace(
        self,
        X: _Input | Path | str | tp.Sequence[Path],
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
    ) -> "BitBirch":
        r"""Break the largest clusters into singletons and re-fit the tree."""
        if not self.is_init:
            raise ValueError("The model has not been fitted yet.")
        self.delete_internal_nodes()
        to_fp, to_mols = self._bf_to_np_refine(
            X, initial_mol=initial_mol, input_is_packed=input_is_packed,
            n_largest=n_largest,
        )
        self.reset()
        for bufs, mol_idxs in zip(to_fp.values(), to_mols.values()):
            self._fit_buffers(bufs, reinsert_index_seqs=mol_idxs)
        return self

    def recluster_inplace(
        self,
        iterations: int = 1,
        extra_threshold: float = 0.0,
        shuffle: bool = False,
        seed: int | None = None,
        verbose: bool = False,
        stop_early: bool = False,
    ) -> "BitBirch":
        r"""Iteratively re-insert all clusters (optionally shuffled), bumping
        the threshold by ``extra_threshold`` each iteration."""
        if not self.is_init:
            raise ValueError("The model has not been fitted yet.")
        engine = self._require_engine()
        singletons_before = 0
        for _ in range(iterations):
            sids = self._get_leaf_bfs(sort=True)
            singletons = sum(1 for s in sids if engine.sub_n(s) == 1)
            if stop_early and (singletons == 0 or singletons == singletons_before):
                break
            singletons_before = singletons
            if verbose:
                print(f"Current number of clusters: {len(sids)}")
                print(f"Current number of singletons: {singletons}")
            if shuffle:
                random.seed(seed)
                random.shuffle(sids)
            to_fp, to_mols = self._prepare_bf_to_buffer_dicts(sids)
            self.reset()
            self.threshold += extra_threshold
            for bufs, mol_idxs in zip(to_fp.values(), to_mols.values()):
                self._fit_buffers(bufs, reinsert_index_seqs=mol_idxs)
            engine = self._require_engine()
        if verbose:
            sids = self._get_leaf_bfs(sort=True)
            singletons = sum(1 for s in sids if engine.sub_n(s) == 1)
            print(f"Final number of clusters: {len(sids)}")
            print(f"Final number of singletons: {singletons}")
        return self

    # -- persistence ---------------------------------------------------------

    def save(self, path: Path | str) -> None:
        r"""Pickle the estimator (flat state; no recursion-depth issues)."""
        with open(path, mode="wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: Path | str) -> "BitBirch":
        r"""Load a pickled estimator."""
        with open(path, mode="rb") as f:
            tree = pickle.load(f)
        if not isinstance(tree, cls):
            raise ValueError("Path does not contain a bitbirch object")
        return tree

    # -- global clustering (experimental, parity with reference) -------------

    def global_clustering(
        self, n_clusters: int, *, method: str = "kmeans", **method_kwargs: tp.Any
    ) -> "BitBirch":
        r""":meta private:"""
        warnings.warn(
            "Global clustering is an experimental feature,"
            " it will be modified without warning, please do not use"
        )
        if not self.is_init:
            raise ValueError("The model has not been fitted yet.")
        centroids = np.vstack(self.get_centroids(packed=False))
        labels = self._centrals_global_clustering(
            centroids, n_clusters, method=method, input_is_packed=False,
            **method_kwargs,
        )
        num_centroids = len(centroids)
        self._n_global_clusters = min(n_clusters, num_centroids)
        self._global_clustering_centroid_labels = labels
        return self

    @staticmethod
    def _centrals_global_clustering(
        centrals: NDArray[np.uint8],
        n_clusters: int,
        *,
        method: str = "kmeans",
        input_is_packed: bool = True,
        n_features: int | None = None,
        **method_kwargs: tp.Any,
    ) -> NDArray[np.int64]:
        r""":meta private:"""
        if method not in {
            "agglomerative", "kmeans", "kmeans-normalized", "kmeans-jax"
        }:
            raise ValueError(f"Unknown method {method}")

        if input_is_packed:
            centrals = unpack_fingerprints(centrals, n_features)
        num_centrals = len(centrals)
        if num_centrals < n_clusters:
            # The reference emits sklearn's ConvergenceWarning here
            # (``bblean/bitbirch.py:1409``); keep that category for callers
            # that filter on it, falling back only on the sklearn-free path
            try:
                from sklearn.exceptions import ConvergenceWarning as _ConvWarn
            except ImportError:  # kmeans-jax works without sklearn
                _ConvWarn = UserWarning  # type: ignore[assignment,misc]
            warnings.warn(
                f"Number of subclusters found ({num_centrals}) by BitBIRCH is"
                f" less than ({n_clusters}). Decrease k or the threshold.",
                _ConvWarn,
                stacklevel=2,
            )
            n_clusters = num_centrals
        if method == "kmeans-jax":
            # Device k-means (matmul Lloyd iterations); no sklearn needed
            from bblean_tpu.ops.kmeans import kmeans_fit_predict

            return kmeans_fit_predict(
                centrals.astype(np.float32), n_clusters, **method_kwargs
            ) + 1
        from sklearn.cluster import AgglomerativeClustering, KMeans

        if method == "kmeans-normalized":
            centrals = centrals / np.linalg.norm(centrals, axis=1, keepdims=True)
        if method in ("kmeans", "kmeans-normalized"):
            predictor = KMeans(n_clusters=n_clusters, **method_kwargs)
        else:
            predictor = AgglomerativeClustering(n_clusters=n_clusters, **method_kwargs)
        # Labels start at 1 so 0 can act as the unassigned sentinel
        return predictor.fit_predict(centrals) + 1

    def __repr__(self) -> str:
        fn = self._merge_accept_fn
        parts = [
            f"threshold={self.threshold}",
            f"branching_factor={self.branching_factor}",
            f"merge_criterion='{fn.name if fn.name in BUILTIN_MERGES else fn}'",
        ]
        if self.tolerance is not None:
            parts.append(f"tolerance={self.tolerance}")
        return f"{self.__class__.__name__}({', '.join(parts)})"
