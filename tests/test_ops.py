r"""Device-op conformance vs the host NumPy reference kernels."""

import numpy as np
import pytest

import bblean_tpu._np_similarity as npsim
from bblean_tpu._merges import get_merge_accept_fn
from bblean_tpu.fingerprints import (
    make_fake_fingerprints,
    pack_fingerprints,
    unpack_fingerprints,
)
from bblean_tpu.ops.isim import (
    isim_from_sums,
    isim_radius_compl_from_sums,
    majority_centroid_from_sums,
)
from bblean_tpu.ops.merges import DEVICE_MERGES, merge_accept_batch
from bblean_tpu.ops.packing import (
    pack_fingerprints_device,
    unpack_fingerprints_device,
)
from bblean_tpu.ops.popcount import popcount_device, popcount_rows
from bblean_tpu.ops.tanimoto import tanimoto_matmul, tanimoto_packed_arr_vec
from bblean_tpu.similarity import (
    jt_isim_radius_compl_from_sum,
)

SEED = 17408390758220920002


def test_pack_unpack_device_matches_numpy() -> None:
    packed = make_fake_fingerprints(32, seed=SEED)
    unpacked = unpack_fingerprints(packed)
    assert (np.asarray(unpack_fingerprints_device(packed)) == unpacked).all()
    assert (np.asarray(pack_fingerprints_device(unpacked)) == packed).all()


def test_pack_device_pads_like_numpy() -> None:
    bits = make_fake_fingerprints(8, n_features=2048, seed=1, pack=False)[:, :100]
    expect = pack_fingerprints(bits)
    got = np.asarray(pack_fingerprints_device(bits))
    assert (got == expect).all()
    trimmed = np.asarray(unpack_fingerprints_device(got, 100))
    assert (trimmed == bits).all()


def test_popcount_device() -> None:
    packed = make_fake_fingerprints(16, seed=SEED)
    expect = npsim.popcount(packed)
    assert (np.asarray(popcount_device(packed)) == expect).all()
    assert (
        np.asarray(popcount_rows(unpack_fingerprints(packed))) == expect
    ).all()


def test_tanimoto_packed_arr_vec() -> None:
    fps = make_fake_fingerprints(64, seed=SEED)
    expect = npsim._jt_sim_arr_vec_packed(fps, fps[0])
    got = np.asarray(tanimoto_packed_arr_vec(fps, fps[0]))
    assert np.allclose(got, expect, atol=1e-6)


def test_tanimoto_matmul_matches_pairwise() -> None:
    fps = make_fake_fingerprints(48, seed=SEED)
    unpacked = unpack_fingerprints(fps)
    got = np.asarray(tanimoto_matmul(unpacked, unpacked))
    for j in (0, 7, 33):
        expect = npsim._jt_sim_arr_vec_packed(fps, fps[j])
        assert np.allclose(got[:, j], expect, atol=1e-6)


def test_isim_from_sums_batched() -> None:
    fps = make_fake_fingerprints(100, seed=SEED, pack=False)
    # Batch of prefix linear sums with varying n
    ns = np.array([2, 5, 10, 50, 100], dtype=np.int32)
    sums = np.stack([fps[:n].sum(0) for n in ns]).astype(np.int32)
    got = np.asarray(isim_from_sums(sums, ns))
    expect = [npsim.jt_isim_from_sum(s.astype(np.uint64), int(n)) for s, n in zip(sums, ns)]
    assert np.allclose(got, expect, atol=1e-6)


def test_isim_from_sums_edges() -> None:
    sums = np.zeros((2, 64), dtype=np.int32)
    ns = np.array([5, 1], dtype=np.int32)
    got = np.asarray(isim_from_sums(sums, ns))
    assert got[0] == 1.0  # all-zero -> 1
    assert np.isnan(got[1])  # n < 2 -> NaN


def test_majority_centroid_batched() -> None:
    fps = make_fake_fingerprints(30, seed=SEED, pack=False)
    ns = np.array([1, 3, 30], dtype=np.int32)
    sums = np.stack([fps[:n].sum(0) for n in ns]).astype(np.int32)
    got = np.asarray(majority_centroid_from_sums(sums, ns))
    for row, n in zip(range(3), ns):
        expect = npsim.centroid_from_sum(sums[row].astype(np.uint64), int(n), pack=False)
        assert (got[row] == expect).all()


def test_radius_compl_batched() -> None:
    fps = make_fake_fingerprints(60, seed=SEED, pack=False)
    ns = np.array([2, 10, 60], dtype=np.int32)
    sums = np.stack([fps[:n].sum(0) for n in ns]).astype(np.int32)
    got = np.asarray(isim_radius_compl_from_sums(sums, ns))
    expect = [
        jt_isim_radius_compl_from_sum(s.astype(np.uint64), int(n))
        for s, n in zip(sums, ns)
    ]
    assert np.allclose(got, expect, atol=1e-5)


@pytest.mark.parametrize("criterion", DEVICE_MERGES)
@pytest.mark.parametrize("threshold", [0.1, 0.3, 0.65])
def test_merge_accept_batch_matches_host(criterion, threshold) -> None:
    fps = make_fake_fingerprints(64, n_features=512, seed=3, pack=False).astype(
        np.int64
    )
    host_fn = get_merge_accept_fn(criterion, 0.05)
    # Candidate merges: old CF of size k vs nominee of size m
    cases = [(1, 1), (1, 3), (4, 1), (8, 1), (10, 5)]
    new_ls, new_n, old_ls, old_n, nom_n, expect = [], [], [], [], [], []
    cursor = 0
    for k, m in cases:
        old = fps[cursor : cursor + k]
        nom = fps[cursor + k : cursor + k + m]
        cursor += k + m
        ols, nls = old.sum(0), nom.sum(0)
        new_ls.append(ols + nls)
        new_n.append(k + m)
        old_ls.append(ols)
        old_n.append(k)
        nom_n.append(m)
        expect.append(
            bool(host_fn(threshold, ols + nls, k + m, ols, nls, k, m))
        )
    got = np.asarray(
        merge_accept_batch(
            criterion,
            threshold,
            np.stack(new_ls).astype(np.int32),
            np.array(new_n, dtype=np.int32),
            np.stack(old_ls).astype(np.int32),
            np.array(old_n, dtype=np.int32),
            np.array(nom_n, dtype=np.int32),
            tolerance=0.05,
        )
    )
    assert got.tolist() == expect


def test_isim_precision_at_scale() -> None:
    r"""Device f32 iSIM must stay within 1e-6 relative of the host float64
    kernel for cluster sizes up to 10M members (the precision contract in
    ``ops/isim.py`` — large merged clusters must not drift)."""
    import jax.numpy as jnp
    import numpy as np

    from bblean_tpu._np_similarity import jt_isim_from_sum
    from bblean_tpu.ops.isim import isim_from_sums

    rng = np.random.default_rng(0)
    for n in (1_000, 100_000, 1_000_000, 10_000_000):
        for density in (0.1, 0.35, 0.9):
            ls = (rng.random(2048) * n * density).astype(np.int64)
            host = jt_isim_from_sum(ls.astype(np.uint64), n)
            dev = float(
                isim_from_sums(
                    jnp.asarray(ls, jnp.int32)[None], jnp.asarray([n])
                )[0]
            )
            assert abs(dev - host) <= 1e-6 * abs(host), (n, density)


def test_kmeans_device() -> None:
    r"""Device k-means recovers well-separated blobs and beats a random
    labeling on inertia (device analogue of sklearn global clustering)."""
    import numpy as np

    from bblean_tpu.ops.kmeans import kmeans_fit_predict

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 64)) * 10.0
    pts = np.concatenate(
        [c + rng.normal(size=(50, 64)) for c in centers]
    ).astype(np.float32)
    labels = kmeans_fit_predict(pts, 4, seed=1)
    assert labels.shape == (200,)
    assert set(labels) == {0, 1, 2, 3}
    # Each true blob maps to exactly one predicted cluster
    for b in range(4):
        blob = labels[b * 50 : (b + 1) * 50]
        assert len(set(blob.tolist())) == 1
    # Deterministic under the same seed
    assert (kmeans_fit_predict(pts, 4, seed=1) == labels).all()
    with pytest.raises(ValueError):
        kmeans_fit_predict(pts, 0)
    with pytest.raises(ValueError):
        kmeans_fit_predict(pts, 201)
    assert (kmeans_fit_predict(pts, 1) == 0).all()
