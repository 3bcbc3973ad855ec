r"""The engine's two search kernels against plain NumPy references.

- ``_search_tiles``: each row's best cell in its routed group's packed tile
  (gather + AND + popcount + argmax).  The reference computes int64
  intersections and the same f32 similarities, so results must be equal:
  best similarity per row, and the slot of the lowest best position.
- ``_route_groups``: argmax Tanimoto over live group centroids, against an
  int64 reference at F=2048 with dead (beyond ``g_num``) and padded rows.
"""

import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bblean_tpu.engine.batch import (
    _CENT_DT,
    _intersections,
    _route_groups,
    _search_tiles,
    _tile_intersections,
)

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _tiles(rng, m, g, fc, f8, concentration):
    t_pk = rng.integers(0, 256, (g, fc, f8), dtype=np.uint8)
    occ = rng.random((g, fc)) < 0.7
    t_slot = np.where(occ, rng.integers(0, 10_000, (g, fc)), -1).astype(
        np.int32
    )
    t_pk[~occ] = 0
    row_pk = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    if concentration == "one":  # merge-heavy: every row one group
        row_group = np.zeros(m, np.int32)
    elif concentration == "spread":  # singleton-heavy: 1-2 rows per group
        row_group = rng.integers(0, g, m).astype(np.int32)
    else:
        row_group = np.sort(rng.integers(0, 3, m)).astype(np.int32)
    pending = rng.random(m) < 0.8
    return row_pk, row_group, t_pk, t_slot, pending


def _search_reference(row_pk, row_group, t_pk, t_slot, pending):
    t_pops = _POP8[t_pk].sum(-1)
    row_pop = _POP8[row_pk].sum(-1)
    inter = _POP8[t_pk[row_group] & row_pk[:, None, :]].sum(-1)
    union = np.maximum(t_pops[row_group] + row_pop[:, None] - inter, 1)
    sims = inter.astype(np.float32) / union.astype(np.float32)
    live = (t_slot[row_group] >= 0) & pending[:, None]
    sims = np.where(live, sims, np.float32(-2.0))
    pos = sims.argmax(1)  # first (lowest) position among equal bests
    rows = np.arange(len(row_pk))
    slot = np.maximum(t_slot[row_group, pos], 0)
    return inter, sims[rows, pos], slot


def _run_search(row_pk, row_group, t_pk, t_slot, pending):
    t_pops = _POP8[t_pk].sum(-1).astype(np.int32)
    row_pop = _POP8[row_pk].sum(-1).astype(np.int32)
    args = [
        jnp.asarray(x)
        for x in (row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
    ]
    sim, slot = jax.jit(_search_tiles)(*args)
    inter = jax.jit(_tile_intersections)(args[0], args[2], args[3])
    return np.asarray(inter), np.asarray(sim), np.asarray(slot)


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shapes = {
        "one": (64, 8, 16, 32, "one"),
        "few": (64, 8, 16, 32, "few"),
        "spread": (64, 8, 16, 32, "spread"),
        "narrow-spread": (128, 32, 8, 8, "spread"),
        "wide-few": (256, 4, 32, 32, "few"),
    }
    if name in shapes:
        return _tiles(rng, *shapes[name])
    row_pk, row_group, t_pk, t_slot, pending = _tiles(
        rng, 64, 8, 16, 32, "spread"
    )
    if name == "all-empty":
        t_slot[:] = -1
        t_pk[:] = 0
    elif name == "pending-mask":
        pending[::2] = False
    elif name == "empty-guard-tile":
        # The last group is the engine's scatter guard: empty, and rows
        # routed there (padding) find no candidate
        t_slot[-1] = -1
        t_pk[-1] = 0
        row_group[::5] = len(t_pk) - 1
    elif name == "ties":
        # Identical cells: the lowest tile position wins
        t_pk[:, 1:] = t_pk[:, :1]
        t_slot[:] = np.arange(t_slot.size).reshape(t_slot.shape)
    return row_pk, row_group, t_pk, t_slot, pending


@pytest.mark.parametrize(
    "case",
    [
        "one", "few", "spread", "narrow-spread", "wide-few", "all-empty",
        "pending-mask", "empty-guard-tile", "ties",
    ],
)
def test_search_tiles_matches_numpy(case) -> None:
    row_pk, row_group, t_pk, t_slot, pending = _case(case)
    inter, sim, slot = _run_search(row_pk, row_group, t_pk, t_slot, pending)
    ref_inter, ref_sim, ref_slot = _search_reference(
        row_pk, row_group, t_pk, t_slot, pending
    )
    np.testing.assert_array_equal(inter, ref_inter)
    np.testing.assert_array_equal(sim, ref_sim)
    np.testing.assert_array_equal(slot, ref_slot)
    if case in ("all-empty",):
        assert (sim == -2.0).all() and (slot == 0).all()
    if case == "pending-mask":
        assert (sim[::2] == -2.0).all()
    if case == "empty-guard-tile":
        assert (sim[row_group == len(t_pk) - 1] == -2.0).all()
    if case == "ties":
        has = sim > -1.5
        np.testing.assert_array_equal(
            slot[has], t_slot[row_group, 0][has]
        )


F = 2048


def _route_case(seed, m, g_cap, g_live):
    rng = np.random.default_rng(seed)
    cents = (rng.random((g_cap, F)) < 0.35).astype(np.uint8)
    base = rng.integers(0, g_live, m)
    flip = rng.random((m, F)) < 0.15
    rows = np.where(flip, 1 - cents[base], cents[base]).astype(np.uint8)
    pending = rng.random(m) < 0.85
    return rows, cents, pending


def _route_reference(rows, cents, pending, g_live):
    inter = rows.astype(np.int64) @ cents[:g_live].T.astype(np.int64)
    union = rows.sum(1)[:, None] + cents[:g_live].sum(1)[None, :] - inter
    sims = inter.astype(np.float32) / np.maximum(union, 1).astype(np.float32)
    return inter, np.where(pending, sims.argmax(1), 0)


def _run_route(rows, cents, pending, g_live, block, dtype=_CENT_DT):
    r = jnp.asarray(rows, dtype=dtype)
    c = jnp.asarray(cents, dtype=dtype)
    best = jax.jit(_route_groups, static_argnames=("block",))(
        r, jnp.asarray(rows.sum(1), jnp.int32), c,
        jnp.asarray(cents.sum(1), jnp.int32), jnp.int32(g_live),
        jnp.asarray(pending), block=block,
    )
    inter = jax.jit(_intersections)(r, c[:g_live])
    return np.asarray(inter), np.asarray(best)


@pytest.mark.parametrize(
    "g_cap,g_live,block",
    [
        (64, 40, 16),  # partial last block; 24 dead rows hold junk bits
        (64, 64, 64),  # one full block, no dead rows
        (96, 17, 128),  # block wider than the table (clamped)
    ],
)
def test_route_groups_matches_int64_reference(g_cap, g_live, block) -> None:
    rows, cents, pending = _route_case(g_cap + g_live, 96, g_cap, g_live)
    inter, best = _run_route(rows, cents, pending, g_live, block)
    ref_inter, ref_best = _route_reference(rows, cents, pending, g_live)
    np.testing.assert_array_equal(inter, ref_inter)
    np.testing.assert_array_equal(best, ref_best)
    assert (best < g_live).all()  # dead groups never win


def test_route_int8_matches_bf16() -> None:
    r"""Both centroid dtypes are exact for 0/1 values: same counts, same
    routing (the engine keeps whichever the card runs faster)."""
    rows, cents, pending = _route_case(7, 128, 128, 100)
    i8 = _run_route(rows, cents, pending, 100, 32, dtype=jnp.int8)
    bf = _run_route(rows, cents, pending, 100, 32, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(i8[0], bf[0])
    np.testing.assert_array_equal(i8[1], bf[1])


def test_predict_packed_matches_depth2_reference() -> None:
    r"""``predict_packed`` (chunking, padding, route + tile search) against
    a NumPy depth-2 search over the fitted tree's own tables."""
    from bblean_tpu.engine.batch import BatchTree
    from bblean_tpu.fingerprints import make_fake_fingerprints

    fps = make_fake_fingerprints(700, seed=3)
    tree = BatchTree(
        F, threshold=0.5, batch_size=64, initial_capacity=1024,
        route_block=32, fanout=24, tile=32,
    )
    tree.fit_packed(fps, range(len(fps)))
    queries = make_fake_fingerprints(150, seed=4)
    slots, sims = tree.predict_packed(queries, batch=64)

    st = tree.state
    g_num = int(st.g_num)
    g_cent = np.asarray(st.g_cent).astype(np.uint8)
    q_bits = np.unpackbits(queries, axis=-1)
    _inter, group = _route_reference(
        q_bits, g_cent, np.ones(len(queries), bool), g_num
    )
    _i, ref_sim, ref_slot = _search_reference(
        queries, group.astype(np.int32), np.asarray(st.t_pk),
        np.asarray(st.t_slot), np.ones(len(queries), bool),
    )
    np.testing.assert_array_equal(sims, ref_sim.astype(np.float64))
    np.testing.assert_array_equal(slots, np.where(ref_sim > -1.5, ref_slot, -1))
    assert (slots >= 0).all()
