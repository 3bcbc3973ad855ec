r"""Batched device engine tests: invariants, near-serial agreement, determinism,
capacity growth, and buffer mode."""

import numpy as np
import pytest

from bblean_tpu import BitBirch
from bblean_tpu._np_similarity import jt_isim_from_sum
from bblean_tpu.engine.batch import BatchTree
from bblean_tpu.fingerprints import make_fake_fingerprints, unpack_fingerprints

SEED = 12620509540149709235


def _fit_batch(fps_unpacked, threshold, criterion="diameter", **kw):
    tree = BatchTree(
        fps_unpacked.shape[1],
        threshold=threshold,
        merge_criterion=criterion,
        batch_size=kw.pop("batch_size", 256),
        initial_capacity=kw.pop("initial_capacity", 1024),
        route_block=kw.pop("route_block", 512),
        **kw,
    )
    tree.insert_fps(fps_unpacked, range(len(fps_unpacked)))
    return tree


def test_all_mols_assigned_once() -> None:
    fps = make_fake_fingerprints(600, seed=SEED, pack=False)
    tree = _fit_batch(fps, 0.3)
    mols = tree.cluster_mols()
    flat = sorted(i for c in mols for i in c)
    assert flat == list(range(600))
    assert tree.cluster_sizes().sum() == 600
    assert all(
        len(m) == s for m, s in zip(mols, tree.cluster_sizes())
    )


def test_diameter_cohesion_invariant() -> None:
    r"""Every committed cluster must satisfy isim >= threshold (diameter)."""
    threshold = 0.3
    fps = make_fake_fingerprints(800, seed=SEED, pack=False)
    tree = _fit_batch(fps, threshold)
    for ls, n in zip(tree.linear_sums(), tree.cluster_sizes()):
        if n >= 2:
            assert jt_isim_from_sum(ls.astype(np.uint64), int(n)) >= threshold - 1e-6


def test_linear_sums_consistent_with_members() -> None:
    fps = make_fake_fingerprints(400, seed=SEED, pack=False)
    tree = _fit_batch(fps, 0.3)
    mols = tree.cluster_mols()
    for ls, members in zip(tree.linear_sums(), mols):
        assert (ls == fps[members].sum(0)).all()


def test_determinism() -> None:
    fps = make_fake_fingerprints(500, seed=SEED, pack=False)
    a = _fit_batch(fps, 0.3)
    b = _fit_batch(fps, 0.3)
    assert a.cluster_mols() == b.cluster_mols()


def test_capacity_growth() -> None:
    # High threshold on random fps -> nearly all singletons -> forced growth
    fps = make_fake_fingerprints(700, seed=3, pack=False)
    tree = BatchTree(
        2048, threshold=0.95, batch_size=128, initial_capacity=256,
        route_block=128,
    )
    tree.insert_fps(fps, range(700))
    assert tree.num_clusters > 600
    assert tree.capacity >= tree.num_clusters
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(700))


def test_near_serial_agreement() -> None:
    r"""Batch labels are not bit-identical to serial, but cluster statistics
    must land close (same data, same criterion)."""
    fps_packed = make_fake_fingerprints(1000, seed=SEED)
    fps = unpack_fingerprints(fps_packed)
    exact = BitBirch(threshold=0.3).fit(fps_packed)
    n_exact = len(exact.get_cluster_mol_ids())
    batch = _fit_batch(fps, 0.3)
    # The batch engine's in-group search is less fragmenting than the serial
    # tree's greedy descent (which scatters genuinely-cohesive dense fps
    # across leaves), so it finds the same or fewer clusters at equal or
    # better cohesion; counts must stay in the same regime
    n_batch = batch.num_clusters
    assert n_batch <= n_exact * 1.3
    assert n_batch >= n_exact * 0.5
    # Quality parity: sample-weighted mean cluster iSIM within 2% of serial
    def weighted_isim(sums, counts):
        tot = w = 0.0
        for ls, n in zip(sums, counts):
            if n >= 2:
                tot += n * jt_isim_from_sum(np.asarray(ls, np.uint64), int(n))
                w += n
        return tot / max(w, 1.0)

    ex_ids = exact.get_cluster_mol_ids()
    w_exact = weighted_isim(
        [fps[c].sum(0) for c in ex_ids], [len(c) for c in ex_ids]
    )
    w_batch = weighted_isim(batch.linear_sums(), batch.cluster_sizes())
    assert w_batch >= w_exact - 0.02


def test_buffer_mode_merge() -> None:
    r"""Re-inserting one tree's CF buffers into a fresh batch tree keeps
    members together and sums consistent (the sharded-merge path)."""
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    first = _fit_batch(fps, 0.3)
    bufs = np.concatenate(
        [first.linear_sums(), first.cluster_sizes()[:, None]], axis=1
    )
    second = BatchTree(
        2048, threshold=0.3, batch_size=128, initial_capacity=512,
        route_block=128,
    )
    second.insert_buffers(bufs, first.cluster_mols())
    assert second.num_clusters <= first.num_clusters
    flat = sorted(i for c in second.cluster_mols() for i in c)
    assert flat == list(range(300))
    for ls, members in zip(second.linear_sums(), second.cluster_mols()):
        assert (ls == fps[members].sum(0)).all()


def test_never_merge_all_singletons() -> None:
    fps = make_fake_fingerprints(100, seed=1, pack=False)
    tree = BatchTree(
        2048, threshold=0.0, merge_criterion="never-merge",
        batch_size=64, initial_capacity=256, route_block=64,
    )
    tree.insert_fps(fps, range(100))
    assert tree.num_clusters == 100
    assert (tree.cluster_sizes() == 1).all()


def test_identical_fps_one_cluster() -> None:
    fps = np.tile(
        make_fake_fingerprints(1, seed=5, pack=False), (50, 1)
    )
    tree = _fit_batch(fps, 0.65)
    assert tree.num_clusters == 1
    assert tree.cluster_sizes()[0] == 50


def test_packed_centroids_match_majority() -> None:
    fps = make_fake_fingerprints(200, seed=SEED, pack=False)
    tree = _fit_batch(fps, 0.3)
    from bblean_tpu._np_similarity import centroid_from_sum

    cents = tree.packed_centroids()
    for i, (ls, n) in enumerate(zip(tree.linear_sums(), tree.cluster_sizes())):
        expect = centroid_from_sum(ls.astype(np.uint64), int(n), pack=True)
        assert (cents[i] == expect).all()


def test_odd_width_fps() -> None:
    r"""Non-multiple-of-128 feature widths flow through the batch engine."""
    fps = make_fake_fingerprints(120, n_features=264, seed=2, pack=False)
    tree = BatchTree(
        264, threshold=0.4, batch_size=64, initial_capacity=512,
        route_block=64, tile=64, fanout=48,
    )
    tree.insert_fps(fps, range(120))
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(120))
    for ls, members in zip(tree.linear_sums(), tree.cluster_mols()):
        assert (ls == fps[members].sum(0)).all()


def test_mixed_fps_then_buffers() -> None:
    r"""Interleaving fingerprint and buffer insertion keeps bookkeeping."""
    fps = make_fake_fingerprints(100, seed=4, pack=False)
    tree = BatchTree(
        2048, threshold=0.3, batch_size=64, initial_capacity=512,
        route_block=64,
    )
    tree.insert_fps(fps[:50], range(50))
    bufs = np.concatenate(
        [fps[50:].astype(np.int64), np.ones((50, 1), np.int64)], axis=1
    )
    tree.insert_buffers(bufs, [[50 + i] for i in range(50)])
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(100))


def test_refine_inplace_explodes_largest() -> None:
    r"""Refining with never-merge leaves the exploded cluster's members as
    singletons while other clusters survive as intact CF buffers."""
    fps = make_fake_fingerprints(400, seed=SEED, pack=False)
    tree = _fit_batch(fps, 0.3)
    sizes_before = np.sort(tree.cluster_sizes())[::-1]
    n_before = tree.num_clusters
    packed = np.packbits(fps, axis=-1)
    tree.refine_inplace(
        packed, n_largest=1, merge_criterion="never-merge",
    )
    # never-merge: nothing re-merges, so the largest cluster's members all
    # become singletons and every other cluster survives unchanged
    assert tree.num_clusters == n_before - 1 + sizes_before[0]
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(400))
    for ls, members in zip(tree.linear_sums(), tree.cluster_mols()):
        assert (ls == fps[members].sum(0)).all()


def test_refine_inplace_from_file(tmp_path) -> None:
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    packed = np.packbits(fps, axis=-1)
    p = tmp_path / "fps.npy"
    np.save(p, packed)
    tree = _fit_batch(fps, 0.3)
    tree.refine_inplace(p, n_largest=2, merge_criterion="tolerance-diameter")
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(300))
    for ls, members in zip(tree.linear_sums(), tree.cluster_mols()):
        assert (ls == fps[members].sum(0)).all()


def test_recluster_inplace_consistency() -> None:
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    tree = _fit_batch(fps, 0.3)
    n_before = tree.num_clusters
    tree.recluster_inplace(shuffle=True, seed=7)
    # Re-inserting whole clusters can only merge, never split
    assert tree.num_clusters <= n_before
    flat = sorted(i for c in tree.cluster_mols() for i in c)
    assert flat == list(range(300))
    for ls, members in zip(tree.linear_sums(), tree.cluster_mols()):
        assert (ls == fps[members].sum(0)).all()


def test_narrow_retry_rounds_label_identical() -> None:
    r"""The compacted narrow retry phase must commit exactly what the
    all-wide round loop commits (every round computation is masked by
    ``pending`` and order-dependent only through relative row order)."""
    import jax.numpy as jnp

    from bblean_tpu.engine.batch import (
        _batch_step_impl,
        _init_state,
        _prep_fp_rows,
    )

    m = 256
    fps = make_fake_fingerprints(m, seed=SEED)
    rows = _prep_fp_rows(jnp.asarray(fps), jnp.ones((m,), bool), 2048)

    def run(narrow):
        state = _init_state(1024, 64, 256, 2048, 512)
        state, assigned, enc = _batch_step_impl(
            state, *rows, jnp.float32(0.3), jnp.float32(0.05),
            criterion="diameter", block=64, max_rounds=24, narrow=narrow,
        )
        return np.asarray(assigned), int(enc), state

    a0, e0, s0 = run(0)
    a1, e1, s1 = run(m // 4)
    np.testing.assert_array_equal(a0, a1)
    assert e0 // 1000 == 0 and e1 // 1000 == 0  # both drained
    np.testing.assert_array_equal(np.asarray(s0.n), np.asarray(s1.n))
    np.testing.assert_array_equal(np.asarray(s0.group), np.asarray(s1.group))


def test_default_capacities_scale_sanely() -> None:
    r"""Default g/ls capacities must track measured occupancy, not blow up
    HBM at scale: tiles are g_capacity*tile*F/8 bytes and a pool row is 4*F
    bytes, so the 10M-row configuration has to stay far under a 16 GB chip
    (measured: 43k groups and <20k pool rows at 10M)."""
    tree = BatchTree(2048, initial_capacity=1 << 24, fanout=384, tile=512)
    tile_gb = tree.g_capacity * tree.tile * 256 / 2**30
    pool_gb = tree.ls_capacity * 2048 * 4 / 2**30
    assert tree.g_capacity >= (1 << 24) // 384  # must be able to saturate
    assert tile_gb <= 9.0, f"default tiles would need {tile_gb:.1f} GB"
    assert pool_gb <= 1.1, f"default ls pool would need {pool_gb:.1f} GB"
    # Small configs keep enough free group slots for one scan window's
    # split/creation headroom (the amount _ensure_capacity demands before
    # every window; cluster-level worst cases pend + grow + retry instead
    # of sizing the table)
    small = BatchTree(2048, initial_capacity=8192, batch_size=1024)
    assert small.g_capacity >= small._scan_g_headroom()
    assert small.ls_capacity >= 2 * 1024 + 1


def _first_occurrence_canon(labels: np.ndarray) -> np.ndarray:
    r"""Renumber labels by first occurrence (partition + creation order)."""
    seen: dict = {}
    out = np.empty(len(labels), np.int64)
    for i, lab in enumerate(labels):
        out[i] = seen.setdefault(int(lab), len(seen))
    return out


@pytest.mark.parametrize("threshold", [0.3, 0.65])
def test_serial_limit_bit_identical_to_exact(threshold) -> None:
    r"""batch_size=1 with no splits IS the serial algorithm: with one
    routing group the in-tile argmax equals the exact engine's flat-leaf
    argmax (huge branching factor), so labels must agree bit-for-bit —
    the device path converges to serial in the limit (VERDICT item 8)."""
    fps = make_fake_fingerprints(384, seed=SEED)

    exact = BitBirch(
        threshold=threshold, branching_factor=1_000_000
    ).fit(fps)
    exact_labels = np.asarray(
        exact.get_assignments(sort=False, check_valid=True), np.int64
    )

    tree = BatchTree(
        2048,
        threshold=threshold,
        batch_size=1,
        fanout=1000,
        tile=1024,
        max_rounds=8,
    )
    tree.fit_packed(fps, range(len(fps)))
    batch_labels = tree.assignments()

    assert np.array_equal(
        _first_occurrence_canon(exact_labels),
        _first_occurrence_canon(batch_labels),
    )


def test_pool_overflow_guard_grows_and_stays_exact() -> None:
    r"""A linear-sum pool sized far below the multi-member cluster count
    forces the in-step pool guard to pend allocations mid-window; the
    flush boundary grows the pool and retries.  Every row must still land
    and every cluster's linear sum must equal the numpy sum of its members
    (CF integrity under transient pool exhaustion)."""
    rng = np.random.default_rng(7)
    base = (rng.random((64, 2048)) < 0.35).astype(np.uint8)
    fps = np.repeat(base, 8, axis=0)  # 512 rows -> ~64 multi-member cls
    perm = rng.permutation(len(fps))
    fps = fps[perm]
    tree = BatchTree(
        2048,
        threshold=0.3,
        batch_size=64,
        initial_capacity=1024,
        ls_capacity=8,  # pool exhausted within the first scan window
    )
    tree.insert_fps(fps, range(len(fps)))
    labels = tree.assignments()
    assert (labels >= 0).all()
    sizes = tree.cluster_sizes()
    assert int(sizes.sum()) == len(fps)
    assert tree.ls_capacity > 8  # the guard forced growth
    ls = tree.linear_sums()
    for c in range(tree.num_clusters):
        members = fps[labels == c]
        np.testing.assert_array_equal(ls[c], members.sum(axis=0))


def test_predict_packed_matches_bruteforce() -> None:
    r"""predict_packed returns a valid cluster slot whose centroid
    similarity matches a host-side recomputation, and on well-separated
    data it finds the globally best centroid."""
    from bblean_tpu._np_similarity import _jt_sim_arr_vec_packed

    rng = np.random.default_rng(11)
    # 6 well-separated dense prototypes + member noise
    protos = (rng.random((6, 2048)) < 0.5).astype(np.uint8)
    members = np.repeat(protos, 40, axis=0)
    flips = rng.random(members.shape) < 0.01
    members = np.where(flips, 1 - members, members).astype(np.uint8)
    tree = _fit_batch(members, 0.5, batch_size=64, initial_capacity=512)

    queries = np.where(
        rng.random((32, 2048)) < 0.01, 1 - protos[rng.integers(0, 6, 32)],
        protos[rng.integers(0, 6, 32)],
    ).astype(np.uint8)
    # Identity queries ensure an in-tree nearest exists
    queries[:6] = protos
    q_packed = np.packbits(queries, axis=-1)
    slots, sims = tree.predict_packed(q_packed, batch=64)
    assert (slots >= 0).all() and (slots < tree.num_clusters).all()

    cents = tree.packed_centroids()
    for q, slot, sim in zip(q_packed, slots, sims):
        all_sims = _jt_sim_arr_vec_packed(cents, q)
        # reported similarity equals the true query<->centroid Tanimoto
        np.testing.assert_allclose(sim, all_sims[slot], atol=1e-6)
        # and is the global best (separated prototypes -> depth-2 == flat)
        np.testing.assert_allclose(sim, all_sims.max(), atol=1e-6)


def test_predict_packed_empty_and_partial_batch() -> None:
    fps = make_fake_fingerprints(100, seed=9, pack=False)
    tree = _fit_batch(fps, 0.3)
    q = np.packbits(fps[:7], axis=-1)  # partial batch (7 < batch)
    slots, sims = tree.predict_packed(q, batch=64)
    assert slots.shape == (7,)
    assert (slots >= 0).all()
    assert (sims > 0.2).all()  # each query has a nearby cluster


def test_chunked_host_staging_matches_device_resident() -> None:
    r"""Host inputs stage in chunks of ``stage_windows`` windows (one bulk
    device_put each, sliced at a traced offset in-program); device inputs
    slice the resident array directly.  Window/batch composition is the
    same on both paths, so clusters must be IDENTICAL — the invariant the
    streamed >HBM path relies on (reference analogue: mmap streaming fit,
    /root/reference/bblean/_memory.py:73-126, which also never changes
    insertion order)."""
    import jax

    packed = make_fake_fingerprints(2500, seed=SEED)  # packed by default

    def fit(inp):
        tree = BatchTree(
            2048, threshold=0.3, batch_size=64, route_block=64,
            initial_capacity=2048, stage_windows=2,
        )
        tree.fit_packed(inp, range(len(packed)))
        return tree

    # window = 16*64 = 1024 rows -> 3 windows, 2-window chunks: the host
    # path spans a full chunk + a padded partial chunk
    host_tree = fit(packed)
    dev_tree = fit(jax.device_put(packed))
    assert host_tree.num_clusters == dev_tree.num_clusters
    assert host_tree.cluster_mols() == dev_tree.cluster_mols()
