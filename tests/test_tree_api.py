r"""BitBirch estimator API tests: edge cases, refinement golden fixtures,
persistence, and lifecycle."""

import numpy as np
import pytest

from bblean_tpu import BitBirch
from bblean_tpu.fingerprints import make_fake_fingerprints, pack_fingerprints

SEED = 12620509540149709235

# Golden fixtures for 100 seeded fps, threshold 0.3, diameter merge
EXPECT_ASSIGNMENTS = [
    1, 5, 6, 1, 1, 7, 8, 9, 1, 10, 1, 2, 11, 52, 12, 13, 14, 15, 16, 17, 18,
    1, 19, 20, 21, 1, 2, 22, 2, 23, 1, 24, 1, 1, 1, 25, 1, 1, 1, 1, 26, 1,
    27, 28, 29, 1, 2, 30, 31, 2, 32, 33, 34, 2, 2, 35, 36, 37, 38, 2, 2, 39,
    1, 1, 40, 1, 1, 1, 1, 41, 42, 2, 2, 43, 44, 2, 2, 45, 2, 2, 2, 46, 2,
    47, 48, 2, 2, 1, 49, 2, 2, 1, 50, 2, 2, 3, 3, 51, 4, 4,
]
EXPECT_ASSIGNMENTS_REFINE = [
    2, 1, 1, 3, 3, 1, 4, 1, 3, 5, 3, 1, 6, 46, 7, 8, 9, 10, 11, 12, 13, 2,
    14, 15, 16, 47, 1, 17, 1, 18, 2, 19, 2, 2, 2, 20, 2, 2, 2, 2, 21, 2, 22,
    23, 24, 2, 1, 25, 3, 1, 26, 27, 28, 1, 1, 29, 30, 31, 32, 1, 1, 33, 2,
    48, 34, 49, 2, 2, 2, 35, 36, 1, 1, 37, 38, 1, 1, 39, 1, 1, 1, 40, 1, 41,
    42, 1, 1, 2, 43, 1, 1, 2, 44, 1, 1, 1, 1, 45, 1, 1,
]


def test_defaults() -> None:
    tree = BitBirch()
    assert tree.branching_factor == 50
    assert tree.threshold == 0.65
    assert tree.merge_criterion == "diameter"


def test_repr() -> None:
    tree = BitBirch(threshold=0.3, merge_criterion="tolerance-diameter")
    s = repr(tree)
    assert "threshold=0.3" in s and "tolerance-diameter" in s


def test_empty_input_raises() -> None:
    fp = pack_fingerprints(np.zeros((0, 2048), dtype=np.uint8))
    with pytest.raises(ValueError):
        BitBirch().fit(fp, n_features=2048)


def test_repeated_fps_form_one_cluster() -> None:
    for repeats in (1, 2, 10):
        zeros = pack_fingerprints(np.zeros((repeats, 2048), dtype=np.uint8))
        assert BitBirch().fit(zeros).get_cluster_mol_ids() == [list(range(repeats))]

        ones = pack_fingerprints(np.ones((repeats, 2048), dtype=np.uint8))
        assert BitBirch().fit(ones).get_cluster_mol_ids() == [list(range(repeats))]

        rng = np.random.default_rng(SEED)
        mixed = pack_fingerprints(
            np.tile(rng.integers(0, 2, (1, 2048), dtype=np.uint8), (repeats, 1))
        )
        assert BitBirch().fit(mixed).get_cluster_mol_ids() == [list(range(repeats))]


def test_refine_golden() -> None:
    fps = make_fake_fingerprints(100, n_features=2048, seed=SEED, pack=True)
    tree = BitBirch(branching_factor=50, threshold=0.3, merge_criterion="diameter")
    tree.fit(fps)
    assert tree.get_assignments().tolist() == EXPECT_ASSIGNMENTS
    tree.refine_inplace(fps)
    assert tree.get_assignments().tolist() == EXPECT_ASSIGNMENTS_REFINE


def test_recluster_inplace() -> None:
    fps = make_fake_fingerprints(200, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    n_before = len(tree.get_cluster_mol_ids())
    tree.recluster_inplace(iterations=2, stop_early=True)
    labels = tree.get_assignments()
    assert labels.shape == (200,)
    assert len(tree.get_cluster_mol_ids()) <= n_before


def test_save_load_roundtrip(tmp_path) -> None:
    fps = make_fake_fingerprints(150, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    path = tmp_path / "tree.pkl"
    tree.save(path)
    loaded = BitBirch.load(path)
    assert loaded.get_cluster_mol_ids() == tree.get_cluster_mol_ids()
    # Loaded trees accept further fits
    loaded.fit(make_fake_fingerprints(50, seed=3))
    assert loaded.num_fitted_fps == 200


def test_delete_internal_nodes_blocks_fit() -> None:
    fps = make_fake_fingerprints(120, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    ids_before = tree.get_cluster_mol_ids()
    tree.delete_internal_nodes()
    # Leaf reads still work
    assert tree.get_cluster_mol_ids() == ids_before
    with pytest.raises(ValueError):
        tree.fit(fps)
    tree.reset()
    tree.fit(fps)
    assert tree.num_fitted_fps == 120


def test_fit_continues_indices() -> None:
    a = make_fake_fingerprints(30, seed=1)
    b = make_fake_fingerprints(30, seed=2)
    tree = BitBirch(threshold=0.3).fit(a).fit(b)
    all_ids = sorted(i for c in tree.get_cluster_mol_ids() for i in c)
    assert all_ids == list(range(60))


def test_reinsert_indices() -> None:
    fps = make_fake_fingerprints(20, seed=1)
    tree = BitBirch(threshold=0.3).fit(fps, reinsert_indices=range(100, 120))
    all_ids = sorted(i for c in tree.get_cluster_mol_ids() for i in c)
    assert all_ids == list(range(100, 120))


def test_fit_buffers_roundtrip() -> None:
    r"""Rebuilding a tree from its own CF buffers preserves cluster members."""
    fps = make_fake_fingerprints(150, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    to_fp, to_mols = tree._bf_to_np()
    rebuilt = BitBirch(threshold=0.3)
    for bufs, mols in zip(to_fp.values(), to_mols.values()):
        rebuilt._fit_buffers(bufs, reinsert_index_seqs=mols)
    # Every original cluster's members stay together after reinsertion
    orig = {frozenset(c) for c in tree.get_cluster_mol_ids()}
    new = tree.get_cluster_mol_ids()
    merged_sets = [frozenset(c) for c in rebuilt.get_cluster_mol_ids()]
    for cluster in merged_sets:
        # Each rebuilt cluster is a union of original clusters
        members = set(cluster)
        covered = [o for o in orig if o <= members]
        assert members == set().union(*covered) if covered else True
    assert sorted(i for c in new for i in c) == sorted(
        i for c in merged_sets for i in c
    )


def test_global_set_merge_compat() -> None:
    import bblean_tpu.tree as tree_mod

    with pytest.warns(UserWarning):
        tree_mod.set_merge("radius")
    try:
        t = BitBirch()
        assert t.merge_criterion == "radius"
        with pytest.raises(ValueError):
            BitBirch(merge_criterion="diameter")
        with pytest.raises(ValueError):
            t.set_merge("diameter")
    finally:
        tree_mod._global_merge_accept = None


def test_get_centroids_and_medoids() -> None:
    fps = make_fake_fingerprints(100, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    cents = tree.get_centroids(packed=True)
    assert all(c.shape == (256,) for c in cents)
    unpacked_cents = tree.get_centroids(packed=False)
    assert all(c.shape == (2048,) for c in unpacked_cents)
    med = tree.get_medoids_mol_ids(fps)
    assert med["medoids"].shape == (len(cents), 256)
    assert med["mol_ids"] == tree.get_cluster_mol_ids()


def test_dump_assignments(tmp_path) -> None:
    import pandas as pd

    fps = make_fake_fingerprints(50, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    out = tmp_path / "assignments.csv"
    tree.dump_assignments(out, smiles=[f"C{i}" for i in range(50)])
    df = pd.read_csv(out)
    assert list(df.columns) == ["assignments", "smiles"]
    assert (df["assignments"].to_numpy() == tree.get_assignments()).all()


def test_global_clustering() -> None:
    fps = make_fake_fingerprints(100, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    with pytest.warns(UserWarning):
        tree.global_clustering(3, n_init=2, random_state=0)
    labels = tree.get_assignments(global_clusters=True)
    assert set(np.unique(labels)) <= {1, 2, 3}
    mol_ids = tree.get_cluster_mol_ids(global_clusters=True)
    assert len(mol_ids) == 3
    assert sorted(i for c in mol_ids for i in c) == list(range(100))


def test_global_clustering_kmeans_tpu() -> None:
    r"""Device k-means path: no sklearn involved, same label contract."""
    fps = make_fake_fingerprints(100, seed=SEED)
    tree = BitBirch(threshold=0.3).fit(fps)
    tree.global_clustering(3, method="kmeans-jax", seed=0)
    labels = tree.get_assignments(global_clusters=True)
    assert set(np.unique(labels)) <= {1, 2, 3}
    mol_ids = tree.get_cluster_mol_ids(global_clusters=True)
    assert len(mol_ids) == 3
    assert sorted(i for c in mol_ids for i in c) == list(range(100))
