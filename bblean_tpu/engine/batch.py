r"""Level-synchronous batched BitBirch engine for JAX devices.

This is the performance path of the framework — the structural re-design of
the reference's pointer-chasing recursive insert (``bblean/bitbirch.py:305-357``)
for accelerators.  The CF-tree is flattened to **depth 2** and stored as flat
device tables:

- **groups** (the analogue of internal-node entries): a routing table of
  group majority centroids ``(G, F) int8`` searched with one matmul per
  round, plus group CF aggregates;
- **clusters** (the leaf subclusters): a flat count table ``n (C,)`` plus a
  **sparse linear-sum pool** — only multi-member clusters own an
  ``(F,) int32`` pool row (``ls_ref``), while a singleton's exact CF is its
  packed tile entry (``F/8`` bytes, no extra storage); plus **per-group
  packed-centroid tiles** ``(G, Fc, F/8) uint8`` — the in-group candidate
  set a routed row actually scores, with AND + ``lax.population_count``.
  A row therefore touches ``G*F`` (matmul) + ``Fc*F/8`` (popcount) work per
  round instead of ``C*F``: the depth-2 analogue of the tree's O(log)
  search, with both levels batched.

Each jitted round of a batch step:

1. routes every row to a group (matmul argmax over group centroids);
2. scores the routed group's centroid tile (packed Tanimoto) -> best
   cluster candidate;
3. batch-evaluates the merge criterion; commits whole conflict groups when
   the merged CF still satisfies the criterion, else only the lowest-index
   row (serial order);
4. elects leaders among rejected rows per routed group, so mutually-similar
   rows open one shared new cluster; creations take tile positions in
   per-group insertion order and pend when the tile is full.

Rows that lose a conflict or hit a full tile retry next round; whatever is
still unassigned after ``max_rounds`` is returned to the **host control
plane**, which splits oversized groups (balanced most-dissimilar-seed
partition over member centroids — reference split: ``bitbirch.py:162-211``)
and re-queues the rows.  All data-plane math is static-shaped and jittable;
topology restructuring is rare, cheap NumPy.

Rows are uploaded to device memory once in packed form (F/8 bytes per row)
and unpacked on device (``fit_packed`` path), instead of per-batch uploads
of unpacked int32 rows (32x the bytes).

Semantics: same merge criteria, thresholds and CF arithmetic as the exact
engine, evaluated in float32 on device.  Labels are near-serial but not
bit-identical — use the exact engine when reference-identical labels are
required.  Cohesion invariants (every committed cluster satisfies its merge
criterion) hold by construction because group commits re-check the criterion
on the merged state.

Buffer-mode rows (pre-aggregated CFs with n > 1) flow through the same step,
which is what the sharded / multiround merge rounds use.
"""

from __future__ import annotations

import functools
import typing as tp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from bblean_tpu._np_similarity import (
    _jt_sim_packed_precalc_cardinalities,
    centroid_from_sum,
    popcount,
)
from bblean_tpu.ops.divide import div_rn
from bblean_tpu.ops.isim import majority_centroid_from_sums
from bblean_tpu.ops.merges import merge_accept_batch
from bblean_tpu.ops.packing import pack_fingerprints_device, unpack_fingerprints_device

__all__ = ["BatchTree", "BatchState"]

_NEG = -2.0  # below any similarity

# Routing/row centroids are EXACTLY 0/1 valued (majority votes or raw
# fingerprint bits), so int8 matmuls with int32 accumulation and bf16
# matmuls with f32 accumulation give identical values.  int8 is kept as the
# faster at the engine's operating point (1M rows: 3.4k-8.3k live groups).
# Route (M=8192, block=1024, F=2048) on an NVIDIA H100 80GB HBM3, int8 vs
# bf16 (benchmarks/route_cost.py): 4096 live groups 0.527 vs 0.689 ms at a
# 400 W power limit, 0.599 vs 0.701 ms at 700 W; 43008 groups 4.00 vs
# 4.18 ms (400 W), 4.31 vs 4.20 ms (700 W).  XLA lowers the s8 dot to its
# own Triton GEMM fusion and the bf16 one to cuBLAS.
_CENT_DT = jnp.int8


class BatchState(tp.NamedTuple):
    r"""Device-side depth-2 CF-tree (capacity-padded flat tables).

    Linear sums live in a **sparse pool**: only multi-member clusters hold a
    pool row (``ls_ref >= 0``).  A singleton's CF needs no storage at all —
    its exact 0/1 linear sum IS its packed tile entry (``t_pk[group, pos]``).
    At high thresholds (~98% singletons) this cuts per-cluster memory from
    ``F * 4`` bytes to ``F / 8``, which is what lets 10M-row runs fit one
    device's memory (the device analogue of the reference's minimum-dtype
    buffers, ``bblean/bitbirch.py:476-499``).
    """

    # Sparse linear-sum pool (multi-member clusters only)
    ls: Array  # (P_cap, F) int32 linear sums
    num_ls: Array  # () int32 allocated pool rows
    # Leaf clusters (flat)
    ls_ref: Array  # (C_cap,) int32 pool row per slot, -1 = singleton
    n: Array  # (C_cap,) int32 sizes (0 = empty slot)
    group: Array  # (C_cap,) int32 owning group id
    pos: Array  # (C_cap,) int32 position within the group tile
    num: Array  # () int32 live clusters
    # Per-group packed-centroid tiles (the in-group search set)
    t_pk: Array  # (G_cap, Fc, F8) uint8 packed centroids
    t_pops: Array  # (G_cap, Fc) int32 centroid popcounts
    t_slot: Array  # (G_cap, Fc) int32 cluster slot per cell (-1 empty)
    # Groups (routing level)
    g_ls: Array  # (G_cap, F) int32
    g_n: Array  # (G_cap,) int32 samples under the group
    g_cent: Array  # (G_cap, F) int8 routing centroids (0/1 values)
    g_pops: Array  # (G_cap,) int32
    g_count: Array  # (G_cap,) int32 clusters in the group
    g_num: Array  # () int32 live groups


def _init_state(
    capacity: int,
    g_capacity: int,
    tile: int,
    n_features: int,
    ls_capacity: int | None = None,
) -> BatchState:
    f8 = (n_features + 7) // 8
    if ls_capacity is None:
        ls_capacity = capacity
    return BatchState(
        ls=jnp.zeros((ls_capacity, n_features), dtype=jnp.int32),
        num_ls=jnp.zeros((), dtype=jnp.int32),
        ls_ref=jnp.full((capacity,), -1, dtype=jnp.int32),
        n=jnp.zeros((capacity,), dtype=jnp.int32),
        group=jnp.zeros((capacity,), dtype=jnp.int32),
        pos=jnp.zeros((capacity,), dtype=jnp.int32),
        num=jnp.zeros((), dtype=jnp.int32),
        t_pk=jnp.zeros((g_capacity, tile, f8), dtype=jnp.uint8),
        t_pops=jnp.zeros((g_capacity, tile), dtype=jnp.int32),
        t_slot=jnp.full((g_capacity, tile), -1, dtype=jnp.int32),
        g_ls=jnp.zeros((g_capacity, n_features), dtype=jnp.int32),
        g_n=jnp.zeros((g_capacity,), dtype=jnp.int32),
        g_cent=jnp.zeros((g_capacity, n_features), dtype=_CENT_DT),
        g_pops=jnp.zeros((g_capacity,), dtype=jnp.int32),
        g_count=jnp.zeros((g_capacity,), dtype=jnp.int32),
        g_num=jnp.ones((), dtype=jnp.int32),  # group 0 exists (empty root)
    )


def _cluster_ls_of(state: BatchState, slots: Array, n_features: int) -> Array:
    r"""Reconstruct (M, F) int32 linear sums for cluster ``slots``:
    pool row when allocated, else the exact singleton bits from the packed
    tile entry."""
    ref = state.ls_ref[slots]
    pool_rows = state.ls[jnp.maximum(ref, 0)]
    pk = state.t_pk[state.group[slots], state.pos[slots]]
    bits = unpack_fingerprints_device(pk, n_features).astype(jnp.int32)
    return jnp.where((ref >= 0)[:, None], pool_rows, bits)


def _grow_state(
    state: BatchState, new_c: int, new_g: int, new_p: int | None = None
) -> BatchState:
    pad_c = new_c - state.n.shape[0]
    pad_g = new_g - state.g_ls.shape[0]
    pad_p = (new_p - state.ls.shape[0]) if new_p is not None else 0
    return BatchState(
        ls=jnp.pad(state.ls, ((0, pad_p), (0, 0))),
        num_ls=state.num_ls,
        ls_ref=jnp.pad(state.ls_ref, (0, pad_c), constant_values=-1),
        n=jnp.pad(state.n, (0, pad_c)),
        group=jnp.pad(state.group, (0, pad_c)),
        pos=jnp.pad(state.pos, (0, pad_c)),
        num=state.num,
        t_pk=jnp.pad(state.t_pk, ((0, pad_g), (0, 0), (0, 0))),
        t_pops=jnp.pad(state.t_pops, ((0, pad_g), (0, 0))),
        t_slot=jnp.pad(
            state.t_slot, ((0, pad_g), (0, 0)), constant_values=-1
        ),
        g_ls=jnp.pad(state.g_ls, ((0, pad_g), (0, 0))),
        g_n=jnp.pad(state.g_n, (0, pad_g)),
        g_cent=jnp.pad(state.g_cent, ((0, pad_g), (0, 0))),
        g_pops=jnp.pad(state.g_pops, (0, pad_g)),
        g_count=jnp.pad(state.g_count, (0, pad_g)),
        g_num=state.g_num,
    )


def _intersections(a: Array, b: Array) -> Array:
    r"""(M, F) x (N, F) 0/1 centroids -> (M, N) f32 intersection counts.

    Integer operands accumulate in int32, floating ones in f32; both are
    exact for 0/1 values up to 2^24 set bits.
    """
    acc = jnp.int32 if jnp.issubdtype(a.dtype, jnp.integer) else jnp.float32
    return lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=acc
    ).astype(jnp.float32)


@jax.named_scope("route_groups")
def _route_groups(
    row_cent: Array,  # (M, F) int8 (0/1 values)
    row_pop: Array,  # (M,) int32
    g_cent: Array,  # (G_cap, F) int8 (0/1 values)
    g_pops: Array,  # (G_cap,) int32
    g_num: Array,  # ()
    pending: Array,  # (M,) bool
    block: int,
) -> Array:
    r"""Argmax Tanimoto over live group centroids (tiled matmul)."""
    m = row_cent.shape[0]
    g_cap = g_cent.shape[0]
    block = min(block, g_cap)
    # Only sweep blocks containing live groups (dynamic loop bound): with a
    # capacity-padded table this is the difference between O(G_cap) and
    # O(G_live) matmul work per round
    n_blocks = (g_num + block - 1) // block

    def body(b, carry):
        best_sim, best_idx = carry
        start = b * block
        cb = lax.dynamic_slice_in_dim(g_cent, start, block, axis=0)
        pb = lax.dynamic_slice_in_dim(g_pops, start, block, axis=0)
        inter = _intersections(row_cent, cb)
        union = (row_pop[:, None] + pb[None, :]).astype(jnp.float32) - inter
        sims = div_rn(inter, jnp.maximum(union, 1.0))
        cols = start + lax.broadcasted_iota(jnp.int32, (m, block), 1)
        sims = jnp.where((cols < g_num) & pending[:, None], sims, _NEG)
        blk_best = jnp.max(sims, axis=1)
        blk_idx = start + jnp.argmax(sims, axis=1).astype(jnp.int32)
        take = blk_best > best_sim
        return (
            jnp.where(take, blk_best, best_sim),
            jnp.where(take, blk_idx, best_idx),
        )

    init = (jnp.full((m,), _NEG, jnp.float32), jnp.zeros((m,), jnp.int32))
    _, best = lax.fori_loop(0, n_blocks, body, init)
    return jnp.where(pending, best, 0)


def _tile_intersections(row_pk: Array, row_group: Array, t_pk: Array) -> Array:
    r"""(M, Fc) int32 ``|row & centroid|`` of each row against every cell of
    its routed group's packed tile (gather + AND + popcount)."""
    tiles = t_pk[row_group]  # (M, Fc, F8) gather
    return jnp.sum(
        lax.population_count(
            jnp.bitwise_and(tiles, row_pk[:, None, :]).astype(jnp.int32)
        ),
        axis=-1,
    )


@jax.named_scope("tile_search")
def _search_tiles(
    row_pk: Array,  # (M, F8) uint8
    row_pop: Array,  # (M,) int32
    row_group: Array,  # (M,) int32
    t_pk: Array,  # (G_cap, Fc, F8) uint8
    t_pops: Array,  # (G_cap, Fc) int32
    t_slot: Array,  # (G_cap, Fc) int32
    pending: Array,  # (M,) bool
) -> tuple[Array, Array]:
    r"""Packed Tanimoto of each row vs its routed group's centroid tile.

    Returns (best_sim, best_slot); best_sim = -2 where the tile is empty.
    """
    pops = t_pops[row_group]  # (M, Fc)
    slots = t_slot[row_group]  # (M, Fc)
    inter = _tile_intersections(row_pk, row_group, t_pk)
    union = pops + row_pop[:, None] - inter
    sims = div_rn(inter.astype(jnp.float32), jnp.maximum(union, 1))
    sims = jnp.where((slots >= 0) & pending[:, None], sims, _NEG)
    best_pos = jnp.argmax(sims, axis=1).astype(jnp.int32)
    m = row_pk.shape[0]
    rows = lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    best_sim = sims[rows, best_pos]
    best_slot = slots[rows, best_pos]
    return best_sim, jnp.maximum(best_slot, 0)


def _group_ids_by_key(key: Array) -> tuple[Array, Array, Array]:
    r"""Stable grouping of rows by an int key -> (order, group_of_sorted,
    is_group_start); equal keys form one group, ordered by row index."""
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]]
    )
    group = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    return order, group, is_start


def _segment_rank(grp: Array, mask_sorted: Array) -> Array:
    r"""Rank of each (sorted) row within its segment, counting masked rows."""
    inc = mask_sorted.astype(jnp.int32)
    csum = jnp.cumsum(inc)
    seg_start_csum = jax.ops.segment_min(
        csum - inc, grp, num_segments=grp.shape[0]
    )
    return csum - inc - seg_start_csum[grp]


def _insert_round(
    state: BatchState,
    pending: Array,
    assigned: Array,
    strikes: Array,
    row_group: Array,
    row_ls: Array,
    row_n: Array,
    row_cent: Array,
    row_pk: Array,
    row_pop: Array,
    threshold: Array,
    tolerance: Array,
    *,
    criterion: str,
    row_sims: Array | None = None,
) -> tuple[BatchState, Array, Array, Array]:
    r"""One insertion round over a row window of any width.

    Every computation is masked by ``pending`` and depends on rows only
    through their RELATIVE order, so running a round over a compacted
    subset of the rows commits exactly what the full-width round would —
    this is what makes the narrow retry rounds label-preserving.

    ``row_group`` is the per-row routed group, computed ONCE per batch step
    (`_route_groups`): within a step the routing inputs never change —
    ``g_cent``/``g_pops`` refresh only in ``_refresh_touched`` after the
    round loop, and groups created mid-step keep zero centroids (similarity
    exactly 0, never an argmax winner over a live group) — so re-routing
    every round returned the identical assignment while paying the
    O(M*G_live*F) matmul again, the term that grows with cluster count.
    ``row_sims`` optionally carries the step-constant all-pairs row
    Tanimoto matrix for the leader election (same argument: it depends
    only on the rows); pass None to compute it in-round (narrow windows).
    """
    m, n_features = row_ls.shape
    tile = state.t_pk.shape[1]
    big = jnp.int32(1 << 30)
    row_idx = lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    force_lead = strikes >= 2

    # ---- 2. in-group candidate search (popcount over packed tiles) ----
    best_sim, best = _search_tiles(
        row_pk, row_pop, row_group, state.t_pk, state.t_pops,
        state.t_slot, pending,
    )
    has_cand = best_sim > -1.5

    # ---- 3. individual merge evaluation ----
    cand_ls = _cluster_ls_of(state, best, n_features)
    cand_n = state.n[best]
    cand_ref = state.ls_ref[best]
    accept = merge_accept_batch(
        criterion, threshold, cand_ls + row_ls, cand_n + row_n, cand_ls,
        cand_n, row_n, tolerance=tolerance,
    )
    # Rows that repeatedly pass the individual screen but lose the
    # commit prefix (marginal fits to a hot cluster) are demoted to the
    # rejected path: serial would have scattered them too, and without
    # the demotion they can spin for all rounds at low thresholds
    accept = accept & pending & has_cand & (strikes < 2)

    # ---- conflict resolution: serial prefix commits per candidate ----
    # Rows accepted toward the same cluster are ordered by row index and
    # committed as the longest prefix for which EVERY cumulative merge
    # still satisfies the criterion — exactly the serial outcome for a
    # same-cluster insertion queue, resolved in one round (winner-only
    # fallbacks drain a queue of Q rows in Q rounds)
    akey = jnp.where(accept, best, big)
    aorder, agrp, astart = _group_ids_by_key(akey)
    a_ok = accept[aorder]
    s_ls = jnp.where(a_ok[:, None], row_ls[aorder], 0)
    s_n = jnp.where(a_ok, row_n[aorder], 0)
    iota_m = row_idx  # 0..m-1
    # Per-row index of its segment's first sorted position
    seg_start = lax.cummax(jnp.where(astart, iota_m, 0))
    # Inclusive cumulative sums within each segment
    cum_ls = jnp.cumsum(s_ls, axis=0)
    cum_n = jnp.cumsum(s_n)
    excl_ls = cum_ls - s_ls
    excl_n = cum_n - s_n
    base_ls = excl_ls[seg_start]
    base_n = excl_n[seg_start]
    pre_ls = excl_ls - base_ls  # sum of earlier rows in the segment
    pre_n = excl_n - base_n
    cand_ls_s = cand_ls[aorder]
    cand_n_s = cand_n[aorder]
    new_ls_s = cand_ls_s + pre_ls + s_ls
    new_n_s = cand_n_s + pre_n + s_n
    acc_pref = (
        merge_accept_batch(
            criterion, threshold, new_ls_s, new_n_s,
            cand_ls_s + pre_ls, cand_n_s + pre_n, s_n,
            tolerance=tolerance,
        )
        & a_ok
    )
    # ---- pass 2 (adaptive): skip failed rows and re-validate ----
    # Serial semantics: a row that fails its merge does NOT contribute mass
    # to later rows' tests — later rows are tested against the state
    # without it.  Pass 1 finds the failures under maximal mass; pass 2
    # recomputes the prefix sums over the surviving rows only and commits
    # the longest prefix for which EVERY surviving cumulative merge holds
    # (each committed state exactly satisfies its criterion).  Without
    # this, every row behind an early failure burns a full extra round.
    # (Runs unconditionally: a lax.cond guard breaks XLA's fusion through
    # the round body.)
    def _commit_pass2(inc2):
        s_ls2 = jnp.where(inc2[:, None], row_ls[aorder], 0)
        s_n2 = jnp.where(inc2, row_n[aorder], 0)
        cum_ls2 = jnp.cumsum(s_ls2, axis=0)
        cum_n2 = jnp.cumsum(s_n2)
        excl_ls2 = cum_ls2 - s_ls2
        excl_n2 = cum_n2 - s_n2
        pre_ls2 = excl_ls2 - excl_ls2[seg_start]
        pre_n2 = excl_n2 - excl_n2[seg_start]
        acc2 = (
            merge_accept_batch(
                criterion, threshold, cand_ls_s + pre_ls2 + s_ls2,
                cand_n_s + pre_n2 + s_n2, cand_ls_s + pre_ls2,
                cand_n_s + pre_n2, s_n2, tolerance=tolerance,
            )
            & inc2
        )
        # Longest prefix among the SURVIVING rows: accepted count so far
        # must equal surviving count so far within the segment
        acc2_i = acc2.astype(jnp.int32)
        inc2_i = inc2.astype(jnp.int32)
        acc2_cum = jnp.cumsum(acc2_i)
        inc2_cum = jnp.cumsum(inc2_i)
        acc2_run = acc2_cum - (acc2_cum - acc2_i)[seg_start]
        inc2_run = inc2_cum - (inc2_cum - inc2_i)[seg_start]
        return acc2 & (acc2_run == inc2_run)

    committed_sorted = _commit_pass2(acc_pref)

    # ---- pool-capacity guard (merge side).  A promotion (a singleton
    # candidate's first merge) allocates a sparse pool row; when the pool
    # is full the allocating segment rolls back whole (its rows pend and
    # the flush boundary grows the pool and retries) instead of the host
    # reserving worst-case pool space per window — that reservation forced
    # a pipeline-draining counter sync every other scan window.  Overflow
    # promos are a suffix of the allocation cumsum, so survivors keep
    # their refs unchanged.
    p_cap_arr = state.ls.shape[0]
    cand_ref_s = cand_ref[aorder]
    cmt_i = committed_sorted.astype(jnp.int32)
    cmt_cum = jnp.cumsum(cmt_i)
    cmt_run = cmt_cum - (cmt_cum - cmt_i)[seg_start]
    seg_any = committed_sorted & (cmt_run == 1)
    promo_try = seg_any & (cand_ref_s < 0)
    ref_promo_sorted = (
        state.num_ls + jnp.cumsum(promo_try.astype(jnp.int32)) - 1
    )
    promo_ok = ~promo_try | (ref_promo_sorted < p_cap_arr - 1)
    seg_ok = jax.ops.segment_min(
        promo_ok.astype(jnp.int32), agrp, num_segments=m
    )[agrp].astype(bool)
    committed_sorted = committed_sorted & seg_ok
    seg_any = seg_any & seg_ok
    # One writer per surviving segment: promotions allocate, adders add
    promo_sorted = promo_try & seg_ok
    adder_sorted = seg_any & (cand_ref_s >= 0)
    n_promo = jnp.sum(promo_sorted.astype(jnp.int32))
    merge_commit = jnp.zeros((m,), bool).at[aorder].set(committed_sorted)

    # ---- 4. leader election among rejected rows (per routed group) ----
    rejected = pending & ~accept
    if criterion == "never-merge":
        leader = rejected
        join = jnp.zeros((m,), bool)
        lead_of = row_idx
    else:
        if row_sims is not None:
            # Step-constant all-pairs sims: every use below is gated on
            # both endpoints being rejected, where the masked and unmasked
            # computations agree exactly
            rsims = row_sims
        else:
            rcent = jnp.where(rejected[:, None], row_cent, 0)
            rsims = _intersections(rcent, rcent)
            rpop = jnp.where(rejected, row_pop, 0)
            runion = rpop[:, None] + rpop[None, :] - rsims
            rsims = div_rn(rsims, jnp.maximum(runion, 1.0))
        same_group = row_group[:, None] == row_group[None, :]
        lower = row_idx[None, :] < row_idx[:, None]  # [j, i]: i < j
        sim_to_lower = jnp.where(
            lower & rejected[None, :] & same_group, rsims, _NEG
        )
        # Rows whose join failed last round self-promote: otherwise a
        # follower of a never-cohesive group can retry forever
        leads = rejected & (
            force_lead | ~jnp.any(sim_to_lower >= threshold, axis=1)
        )
        sim_to_leader = jnp.where(leads[None, :], sim_to_lower, _NEG)
        lead_of = jnp.argmax(sim_to_leader, axis=1).astype(jnp.int32)
        best_lead_sim = jnp.max(sim_to_leader, axis=1)
        join = rejected & ~leads & (best_lead_sim >= threshold)
        leader = leads
        lead_of = jnp.where(leader, row_idx, lead_of)

    # Cohesion check of each leader's would-be cluster (new clusters have
    # no history, so every criterion reduces to its screen)
    jkey = jnp.where(leader | join, lead_of, big)
    jorder, jgrp, _jstart = _group_ids_by_key(jkey)
    j_ok = (leader | join)[jorder]
    j_ls = jnp.where(j_ok[:, None], row_ls[jorder], 0)
    j_n = jnp.where(j_ok, row_n[jorder], 0)
    gj_ls = jax.ops.segment_sum(j_ls, jgrp, num_segments=m)
    gj_n = jax.ops.segment_sum(j_n, jgrp, num_segments=m)
    gj_ok = merge_accept_batch(
        criterion, threshold, gj_ls, jnp.maximum(gj_n, 2),
        jnp.zeros_like(gj_ls), jnp.ones_like(gj_n), gj_n,
        tolerance=tolerance,
    ) | (gj_n <= 1)
    join_ok = jnp.zeros((m,), bool).at[jorder].set(gj_ok[jgrp])
    join_commit = join & join_ok
    # Followers of a non-cohesive would-be cluster become creators in the
    # SAME round (waiting a round to re-elect costs a full round of the
    # while loop for no quality gain)
    creator = leader | (join & ~join_ok)

    # ---- pool-capacity guard (create side).  Multi-member creations
    # (leader + joiners) also allocate pool rows; allocation runs in row
    # order, so non-fitting creations are the suffix of the cumsum and
    # dropping them leaves survivors' refs contiguous.  Dropped creators
    # (and their joiners) pend like full-tile creators do.  MUST run
    # BEFORE tile positions are ranked: a killed creator that held a rank
    # would leave a hole in its group's tile positions, and the next
    # round's creation would collide with the row after the hole
    # (t_slot overwrite = silent CF corruption).
    gj_full_ls = jnp.zeros_like(row_ls).at[jorder].set(
        gj_ls[jgrp], unique_indices=True
    )
    gj_full_n = jnp.zeros((m,), jnp.int32).at[jorder].set(
        gj_n[jgrp], unique_indices=True
    )
    pool_created_ls = jnp.where(join_ok[:, None], gj_full_ls, row_ls)
    pool_created_n = jnp.where(join_ok, gj_full_n, row_n)
    create_pool_try = creator & (pool_created_n >= 2)
    ref_create = (
        state.num_ls
        + n_promo
        + jnp.cumsum(create_pool_try.astype(jnp.int32))
        - 1
    )
    create_ok = ~create_pool_try | (ref_create < p_cap_arr - 1)
    creator = creator & create_ok
    join_commit = join_commit & create_ok[lead_of]

    # ---- 5. tile positions for new clusters (per-group, index order);
    # creations into full tiles open a fresh overflow group so the step
    # always makes progress (host splits rebalance later) ----
    ckey = jnp.where(creator, row_group, big)
    corder, cgrp, _cstart = _group_ids_by_key(ckey)
    crank_sorted = _segment_rank(cgrp, creator[corder])
    crank = jnp.zeros((m,), jnp.int32).at[corder].set(crank_sorted)
    new_pos = state.g_count[row_group] + crank
    # Creations beyond the tile open fresh groups, packed densely in
    # chunks of `tile` per routed group (not one group per leader)
    chunk = new_pos // tile  # 0 = fits the routed group's tile
    chunk_sorted = jnp.where(creator[corder], chunk[corder], 0)
    # segment_max fills EMPTY segments with int32-min: clamp to 0
    seg_new = jnp.maximum(
        jax.ops.segment_max(chunk_sorted, cgrp, num_segments=m), 0
    )  # new groups needed per routed-group segment
    seg_base = jnp.cumsum(seg_new) - seg_new
    seg_of_row = jnp.zeros((m,), jnp.int32).at[corder].set(cgrp)
    over_group = state.g_num + seg_base[seg_of_row] + (chunk - 1)
    fits = chunk == 0
    # Rows whose overflow group would exceed capacity pend; the host
    # grows the tables and retries (keeps capacity checks sync-free).
    # Within each routed-group segment over_group is monotone in rank, so
    # these kills are a rank suffix — survivors' positions stay contiguous
    # (no tile-position holes, unlike a row-order kill would leave).
    g_cap_arr = state.g_ls.shape[0]
    fits_g = fits | (over_group < g_cap_arr - 1)
    tgt_group = jnp.where(fits, row_group, over_group)
    tgt_pos = jnp.where(fits, new_pos, new_pos % tile)
    create_commit = creator & fits_g
    join_commit = join_commit & fits_g[lead_of]
    # Pool refs of fits_g-killed multi-member creators stay consumed (the
    # cumsum above already skipped past them) — a rare, tiny pool leak in
    # exchange for hole-free positions and contiguous surviving refs
    create_pool = create_pool_try & create_ok & fits_g

    lead_rank = jnp.cumsum(create_commit.astype(jnp.int32)) - 1
    new_slot = state.num + lead_rank
    slot_of_row = jnp.where(
        merge_commit,
        best,
        jnp.where(
            create_commit,
            new_slot,
            jnp.where(join_commit, new_slot[lead_of], -1),
        ),
    )
    commit = merge_commit | create_commit | join_commit

    # ---- 6. scatter-commit the flat cluster tables.  Masked rows use an
    # out-of-bounds index + mode="drop": a shared in-bounds guard slot
    # makes XLA serialize the duplicate updates ----
    c_cap_arr = state.n.shape[0]
    num = state.num + jnp.sum(create_commit.astype(jnp.int32))
    g_num = jnp.minimum(
        state.g_num + jnp.sum(seg_new), jnp.int32(g_cap_arr - 1)
    )
    new_slot_drop = jnp.where(create_commit, new_slot, c_cap_arr)
    cg = state.group.at[new_slot_drop].set(
        tgt_group, mode="drop", unique_indices=True
    )
    cpos = state.pos.at[new_slot_drop].set(
        tgt_pos, mode="drop", unique_indices=True
    )
    g_count = state.g_count.at[
        jnp.where(create_commit, tgt_group, g_cap_arr)
    ].add(1, mode="drop")

    # ---- 7. aggregates of joint creations + tile entries for CREATED
    # clusters only.  Merged clusters keep a slightly stale tile centroid
    # within this step; the post-loop refresh rebuilds every touched tile
    # entry from the CF truth once per step instead of every round) ----
    created_ls = jnp.where(
        (join_ok & fits)[:, None], gj_full_ls, row_ls
    )
    created_n = jnp.where(join_ok & fits, gj_full_n, row_n)
    c_cent = majority_centroid_from_sums(
        created_ls, jnp.maximum(created_n, 1)
    )
    c_packed = pack_fingerprints_device(c_cent)
    ts_g = jnp.where(create_commit, tgt_group, g_cap_arr)
    t_pk = state.t_pk.at[ts_g, tgt_pos].set(
        c_packed, mode="drop", unique_indices=True
    )
    t_pops = state.t_pops.at[ts_g, tgt_pos].set(
        jnp.sum(c_cent.astype(jnp.int32), axis=-1),
        mode="drop",
        unique_indices=True,
    )
    t_slot = state.t_slot.at[ts_g, tgt_pos].set(
        new_slot, mode="drop", unique_indices=True
    )

    # ---- 8. sparse linear-sum pool bookkeeping.  Pool rows are
    # allocated for (a) singletons receiving their first merge
    # ("promotion": old bits + this round's committed rows) and (b)
    # multi-member creations (leader + joiners aggregated).  Capacity is
    # guaranteed by the host: promotions + pooled creations per batch
    # never exceed the valid row count.  All merge updates are
    # PRE-AGGREGATED per candidate segment (one writer row each) —
    # per-row scatter-adds serialize whenever many rows hit the same
    # hot cluster, which is the norm at low thresholds. ----
    seg_add_ls = jax.ops.segment_sum(
        jnp.where(committed_sorted[:, None], row_ls[aorder], 0),
        agrp,
        num_segments=m,
    )[agrp]  # (M, F): each sorted row -> its segment's committed sum
    # Advance past every CONSUMED ref (incl. fits_g-killed creators'):
    # survivors' refs are interleaved with the killed ones, so advancing
    # only by the committed count would hand a written ref out again
    num_ls = (
        state.num_ls
        + n_promo
        + jnp.sum((create_pool_try & create_ok).astype(jnp.int32))
    )
    pool = state.ls.at[
        jnp.where(promo_sorted, ref_promo_sorted, p_cap_arr)
    ].set(cand_ls_s + seg_add_ls, mode="drop", unique_indices=True)
    pool = pool.at[
        jnp.where(adder_sorted, cand_ref_s, p_cap_arr)
    ].add(seg_add_ls, mode="drop", unique_indices=True)
    pool = pool.at[jnp.where(create_pool, ref_create, p_cap_arr)].set(
        pool_created_ls, mode="drop", unique_indices=True
    )
    best_s = best[aorder]
    ls_ref = state.ls_ref.at[
        jnp.where(promo_sorted, best_s, c_cap_arr)
    ].set(ref_promo_sorted, mode="drop", unique_indices=True)
    ls_ref = ls_ref.at[jnp.where(create_pool, new_slot, c_cap_arr)].set(
        ref_create, mode="drop", unique_indices=True
    )

    # Cluster counts, pre-aggregated the same way: one writer per merge
    # segment, creations carry their joiners' counts
    seg_add_n = jax.ops.segment_sum(
        jnp.where(committed_sorted, row_n[aorder], 0),
        agrp,
        num_segments=m,
    )[agrp]
    n = state.n.at[jnp.where(seg_any, best_s, c_cap_arr)].add(
        seg_add_n, mode="drop", unique_indices=True
    )
    n = n.at[jnp.where(create_commit, new_slot, c_cap_arr)].add(
        pool_created_n, mode="drop", unique_indices=True
    )

    # (group CFs g_ls/g_n are folded in ONCE per step by
    # _refresh_touched — nothing inside the loop reads them)

    assigned = jnp.where(commit, slot_of_row, assigned)
    pending = pending & ~commit
    struck = pending & (
        (accept & ~merge_commit)
        | (join & ~join_commit)
        | (leader & ~create_commit)
    )
    strikes = jnp.where(pending, strikes + struck.astype(jnp.int32), 0)
    new_state = BatchState(
        pool, num_ls, ls_ref, n, cg, cpos, num, t_pk, t_pops, t_slot,
        state.g_ls, state.g_n, state.g_cent, state.g_pops, g_count, g_num,
    )
    return new_state, pending, assigned, strikes


def _batch_step_impl(
    state: BatchState,
    row_ls: Array,  # (M, F) int32
    row_n: Array,  # (M,) int32 (0 rows are padding)
    row_cent: Array,  # (M, F) int8 (0/1 values)
    row_pk: Array,  # (M, F8) uint8 packed centroid
    row_pop: Array,  # (M,) int32
    threshold: Array,  # () f32
    tolerance: Array,  # () f32
    *,
    criterion: str,
    block: int,
    max_rounds: int,
    narrow: int = 0,
) -> tuple[BatchState, Array]:
    r"""Insert one batch of CF rows.

    Returns (state, assigned slot per row, pending * 1000 + rounds);
    assigned == -1 marks rows the host must retry after splitting oversized
    groups.

    Rounds run FULL-WIDTH while more than ``narrow`` rows are pending, then
    switch to compacted retry rounds over the ``narrow`` lowest-index
    pending rows (re-selected every round).  Tail rounds process a handful
    of stragglers — at t=0.65 rounds 2-3 carry <2.5k of 8192 rows — so
    shrinking them cuts the quadratic leader election 16x and every linear
    term 4x at narrow = M/4.  Label-preserving: see ``_insert_round``.
    ``narrow=0`` disables the narrow phase.
    """
    m, _n_features = row_ls.shape

    # Step-constant work, hoisted out of the round loop (the routing
    # inputs and the rows never change within a step — see _insert_round):
    # the O(M*G_live*F) route matmul is the one per-round term that grows
    # with the cluster count, so paying it once instead of once per round
    # is what keeps large-scale throughput near the small-scale rate.
    pending0 = row_n > 0
    row_group = _route_groups(
        row_cent, row_pop, state.g_cent, state.g_pops, state.g_num,
        pending0, block,
    )
    if criterion != "never-merge":
        row_sims = _intersections(row_cent, row_cent)
        union = (row_pop[:, None] + row_pop[None, :]).astype(
            jnp.float32
        ) - row_sims
        row_sims = div_rn(row_sims, jnp.maximum(union, 1.0))
    else:
        row_sims = None

    def wide_cond(carry):
        _state, pending, _assigned, _strikes, r = carry
        n_pend = jnp.sum(pending.astype(jnp.int32))
        limit = jnp.int32(narrow if 0 < narrow < m else 0)
        return (r < max_rounds) & (n_pend > limit)

    def wide_body(carry):
        state, pending, assigned, strikes, r = carry
        state, pending, assigned, strikes = _insert_round(
            state, pending, assigned, strikes, row_group,
            row_ls, row_n, row_cent, row_pk, row_pop,
            threshold, tolerance, criterion=criterion, row_sims=row_sims,
        )
        return (state, pending, assigned, strikes, r + 1)

    assigned0 = jnp.full((m,), -1, jnp.int32)
    strikes0 = jnp.zeros((m,), jnp.int32)
    carry = lax.while_loop(
        wide_cond, wide_body,
        (state, pending0, assigned0, strikes0, jnp.int32(0)),
    )
    state, pending, assigned, strikes, rounds = carry

    if 0 < narrow < m:
        mn = narrow

        def narrow_cond(carry):
            _state, pending, _assigned, _strikes, r = carry
            return (r < max_rounds) & jnp.any(pending)

        def narrow_body(carry):
            state, pending, assigned, strikes, r = carry
            # Compact the pending rows to the front (stable: original
            # order preserved, which is all the round logic depends on)
            order = jnp.argsort(~pending, stable=True)
            sel = order[:mn]
            sub_pending = pending[sel]
            # row_sims=None: recomputing the (narrow x narrow) sims is
            # cheaper than gathering the scattered rows of the full matrix
            state, sub_pending, sub_assigned, sub_strikes = _insert_round(
                state, sub_pending, jnp.full((mn,), -1, jnp.int32),
                strikes[sel], row_group[sel],
                row_ls[sel], row_n[sel], row_cent[sel], row_pk[sel],
                row_pop[sel], threshold, tolerance, criterion=criterion,
            )
            assigned = assigned.at[sel].set(
                jnp.where(sub_assigned >= 0, sub_assigned, assigned[sel]),
                unique_indices=True,
            )
            pending = pending.at[sel].set(sub_pending, unique_indices=True)
            strikes = strikes.at[sel].set(sub_strikes, unique_indices=True)
            return (state, pending, assigned, strikes, r + 1)

        carry = lax.while_loop(
            narrow_cond, narrow_body,
            (state, pending, assigned, strikes, rounds),
        )
        state, pending, assigned, _strikes, rounds = carry

    state = _refresh_touched(state, assigned, row_ls, row_n)
    return state, assigned, jnp.sum(pending.astype(jnp.int32)) * 1000 + rounds


def _refresh_touched(
    state: BatchState, assigned: Array, row_ls: Array, row_n: Array
) -> BatchState:
    r"""Fold committed rows into their group CFs and refresh derived tables
    (tile + routing centroids) for the clusters and groups this step
    committed to — once per step, not per round."""
    guard_c = state.n.shape[0] - 1
    n_features = state.g_ls.shape[1]
    g_cap = state.g_ls.shape[0]

    ok = assigned >= 0
    slots = jnp.where(ok, assigned, guard_c)  # guard ok for gathers only
    groups = state.group[slots]

    # Group CF accumulation (deferred from the round loop: nothing inside
    # the loop reads g_ls/g_n, so one scatter per step suffices).  Rows are
    # pre-aggregated per group — duplicate scatter indices serialize.
    m = assigned.shape[0]
    gkey = jnp.where(ok, groups, jnp.int32(1 << 30))
    gorder, ggrp, gstart = _group_ids_by_key(gkey)
    ok_sorted = ok[gorder]
    grp_sum_ls = jax.ops.segment_sum(
        jnp.where(ok_sorted[:, None], row_ls[gorder], 0),
        ggrp,
        num_segments=m,
    )[ggrp]
    grp_sum_n = jax.ops.segment_sum(
        jnp.where(ok_sorted, row_n[gorder], 0), ggrp, num_segments=m
    )[ggrp]
    writer = gstart & ok_sorted
    g_idx = jnp.where(writer, groups[gorder], g_cap)
    g_ls = state.g_ls.at[g_idx].add(
        grp_sum_ls, mode="drop", unique_indices=True
    )
    g_n = state.g_n.at[g_idx].add(
        grp_sum_n, mode="drop", unique_indices=True
    )
    state = state._replace(g_ls=g_ls, g_n=g_n)

    # Tile entries: one writer per distinct touched cluster
    skey = jnp.where(ok, slots, jnp.int32(1 << 30))
    sorder, _sgrp, sstart = _group_ids_by_key(skey)
    writer_c = sstart & ok[sorder]
    slots_s = slots[sorder]
    t_ls = _cluster_ls_of(state, slots_s, n_features)
    t_n = state.n[slots_s]
    cents = majority_centroid_from_sums(t_ls, jnp.maximum(t_n, 1))
    pk = pack_fingerprints_device(cents)
    pops = jnp.sum(cents.astype(jnp.int32), axis=-1)
    tg = jnp.where(writer_c, state.group[slots_s], g_cap)
    tp = state.pos[slots_s]
    t_pk = state.t_pk.at[tg, tp].set(pk, mode="drop", unique_indices=True)
    t_pops = state.t_pops.at[tg, tp].set(
        pops, mode="drop", unique_indices=True
    )

    # Routing centroids: one writer per distinct touched group (g_ls is
    # already updated above)
    groups_s = jnp.where(ok_sorted, groups[gorder], 0)
    g_cents = majority_centroid_from_sums(
        state.g_ls[groups_s], jnp.maximum(state.g_n[groups_s], 1)
    ).astype(_CENT_DT)
    g_cent = state.g_cent.at[g_idx].set(
        g_cents, mode="drop", unique_indices=True
    )
    g_pops = state.g_pops.at[g_idx].set(
        jnp.sum(g_cents.astype(jnp.int32), -1),
        mode="drop",
        unique_indices=True,
    )
    return state._replace(
        t_pk=t_pk, t_pops=t_pops, g_cent=g_cent, g_pops=g_pops
    )


# Jitted entry used by the host driver; the raw impl is reused inside the
# SPMD sharded program (bblean_tpu.parallel.sharded)
_batch_step = functools.partial(
    jax.jit,
    static_argnames=("criterion", "block", "max_rounds", "narrow"),
    donate_argnums=(0,),
)(_batch_step_impl)


def _split_topk_impl(
    state: BatchState, *, k: int, fanout: int
) -> tuple[BatchState, Array]:
    r"""Select the K most-populated groups and split the oversized ones
    (pure device math — reused inside the fused batch scan).

    Returns (state, number of oversized groups remaining).
    """
    g_cap = state.g_count.shape[0]
    live = lax.broadcasted_iota(jnp.int32, (g_cap, 1), 0)[:, 0] < state.g_num
    counts = jnp.where(live, state.g_count, 0)
    vals, gs = lax.top_k(counts, k)
    active = vals > fanout
    n_over = jnp.sum((counts > fanout).astype(jnp.int32))
    state = _split_groups_device_impl(state, gs.astype(jnp.int32), active)
    return state, n_over - jnp.sum(active.astype(jnp.int32))


@functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("k", "fanout")
)
def _split_topk_device(
    state: BatchState, *, k: int, fanout: int
) -> tuple[BatchState, Array]:
    r"""Jitted ``_split_topk_impl`` — one dispatch, no host pulls (a
    host-side selection costs a full pipeline sync per boundary)."""
    return _split_topk_impl(state, k=k, fanout=fanout)


@functools.partial(jax.jit, donate_argnums=(0,))
def _split_groups_device(
    state: BatchState,
    gs: Array,  # (K,) int32 group ids to split (pads repeat entry 0)
    active: Array,  # (K,) bool (False = padding, no-op)
) -> BatchState:
    return _split_groups_device_impl(state, gs, active)


def _split_groups_device_impl(
    state: BatchState,
    gs: Array,  # (K,) int32 group ids to split (pads repeat entry 0)
    active: Array,  # (K,) bool (False = padding, no-op)
) -> BatchState:
    r"""Split K oversized groups entirely on device (one dispatch).

    Reference node-split semantics with a balanced partition: seeds are the
    most-dissimilar pair of member centroids (centroid -> fp1 -> fp2,
    ``bblean/bitbirch.py:190-211``); members ranked by (sim-to-fp1 -
    sim-to-fp2) and the top half moves to the new group.  Balance keeps tile
    occupancy high, which the tiled layout needs (the reference's pointer
    lists do not).
    """
    k = gs.shape[0]
    tile = state.t_pk.shape[1]
    f8 = state.t_pk.shape[2]
    guard_g = state.g_ls.shape[0] - 1
    new_gs = state.g_num + jnp.cumsum(active.astype(jnp.int32)) - 1

    t_pk = state.t_pk[gs]  # (K, tile, F8)
    t_pops = state.t_pops[gs]  # (K, tile)
    t_slot = state.t_slot[gs]  # (K, tile)
    occupied = t_slot >= 0

    # Seed centroid: exact group-CF majority vote, packed
    g_ls = state.g_ls[gs]
    g_n = state.g_n[gs]
    seed_bits = majority_centroid_from_sums(g_ls, jnp.maximum(g_n, 1))
    seed_pk = pack_fingerprints_device(seed_bits)  # (K, F8)
    seed_pop = jnp.sum(seed_bits.astype(jnp.int32), axis=-1)

    def packed_sims(vec_pk, vec_pop):
        # Tanimoto of each tile cell vs a per-row packed vector
        inter = jnp.sum(
            lax.population_count(
                jnp.bitwise_and(t_pk, vec_pk[:, None, :]).astype(jnp.int32)
            ),
            axis=-1,
        )
        union = t_pops + vec_pop[:, None] - inter
        sims = div_rn(inter.astype(jnp.float32), jnp.maximum(union, 1))
        return jnp.where(occupied, sims, 2.0)  # empty cells never argmin

    rows = lax.broadcasted_iota(jnp.int32, (k, 1), 0)[:, 0]
    sims_seed = packed_sims(seed_pk, seed_pop)
    i1 = jnp.argmin(sims_seed, axis=1).astype(jnp.int32)
    fp1 = t_pk[rows, i1]
    sims1 = packed_sims(fp1, t_pops[rows, i1])
    i2 = jnp.argmin(sims1, axis=1).astype(jnp.int32)
    fp2 = t_pk[rows, i2]
    sims2 = packed_sims(fp2, t_pops[rows, i2])

    inf = jnp.float32(jnp.inf)
    margin = sims1 - sims2
    margin = jnp.where(occupied, margin, -inf)  # empty cells stay put
    col = lax.broadcasted_iota(jnp.int32, (k, tile), 1)
    margin = jnp.where(col == i1[:, None], inf, margin)
    margin = jnp.where(col == i2[:, None], -inf, margin)
    # Balanced partition: top half (by margin, stable) moves to the new group
    order = jnp.argsort(-margin, axis=1, stable=True)  # sorted pos -> cell
    n_occ = jnp.sum(occupied.astype(jnp.int32), axis=1)
    half = n_occ // 2
    rows_b = jnp.repeat(rows[:, None], tile, 1)
    pos_in_sort = (
        jnp.zeros((k, tile), jnp.int32).at[rows_b, order].set(col)
    )  # cell -> its sorted position
    to_new = occupied & (pos_in_sort < half[:, None])

    # Dense new positions within each half (stable by original cell order)
    def dense_pos(mask):
        return jnp.cumsum(mask.astype(jnp.int32), axis=1) - mask.astype(
            jnp.int32
        )

    pos_moved = dense_pos(to_new & occupied)
    pos_kept = dense_pos(~to_new & occupied)
    member_pos = jnp.where(to_new, pos_moved, pos_kept)

    # Re-pack tiles: scatter each occupied cell into (half, new position);
    # empty source cells drop via an OOB destination
    half_idx = jnp.where(to_new, 1, 0)
    dst_cell = jnp.where(occupied, member_pos, tile)
    new_t_pk = jnp.zeros((k, 2, tile, f8), jnp.uint8).at[
        rows_b, half_idx, dst_cell
    ].set(t_pk, mode="drop", unique_indices=True)
    new_t_pops = jnp.zeros((k, 2, tile), jnp.int32).at[
        rows_b, half_idx, dst_cell
    ].set(t_pops, mode="drop", unique_indices=True)
    new_t_slot = jnp.full((k, 2, tile), -1, jnp.int32).at[
        rows_b, half_idx, dst_cell
    ].set(t_slot, mode="drop", unique_indices=True)

    # Cluster -> (group, pos) updates; masked writes drop via OOB indices
    # (a shared guard slot would serialize the duplicate updates).  The
    # sentinel must be the CLUSTER capacity: using the (smaller) pool
    # capacity here silently rewrote slot `ls_capacity`'s group/pos on
    # every split whenever ls_capacity < capacity.
    c_cap = state.n.shape[0]
    live = occupied & active[:, None]
    flat_slot = jnp.where(live, t_slot, c_cap).reshape(-1)
    member_grp = jnp.where(to_new, new_gs[:, None], gs[:, None])
    group = state.group.at[flat_slot].set(
        member_grp.reshape(-1), mode="drop", unique_indices=True
    )
    pos = state.pos.at[flat_slot].set(
        member_pos.reshape(-1), mode="drop", unique_indices=True
    )

    # Group CFs of the two halves
    w_moved = (to_new & occupied).astype(jnp.int32)
    n_features = state.g_ls.shape[1]
    cluster_ls = _cluster_ls_of(
        state, jnp.maximum(t_slot, 0).reshape(-1), n_features
    ).reshape(k, tile, -1)
    cluster_n = state.n[jnp.maximum(t_slot, 0).reshape(-1)].reshape(k, tile)
    moved_ls = jnp.sum(cluster_ls * w_moved[:, :, None], axis=1)
    moved_n = jnp.sum(cluster_n * w_moved, axis=1)
    kept_ls = g_ls - moved_ls
    kept_n = g_n - moved_n

    g_cap = state.g_ls.shape[0]
    gi = jnp.where(
        active[:, None], jnp.stack([gs, new_gs], axis=1), g_cap
    ).reshape(-1)  # OOB for inactive pairs: scatters drop them
    pair_ls = jnp.stack([kept_ls, moved_ls], axis=1).reshape(2 * k, -1)
    pair_n = jnp.stack([kept_n, moved_n], axis=1).reshape(2 * k)
    pair_cent = majority_centroid_from_sums(pair_ls, jnp.maximum(pair_n, 1))
    pair_counts = jnp.stack(
        [n_occ - jnp.sum(w_moved, axis=1), jnp.sum(w_moved, axis=1)], axis=1
    ).reshape(2 * k)

    def dset(tab, val):
        return tab.at[gi].set(val, mode="drop", unique_indices=True)

    return state._replace(
        group=group,
        pos=pos,
        t_pk=dset(state.t_pk, new_t_pk.reshape(2 * k, tile, f8)),
        t_pops=dset(state.t_pops, new_t_pops.reshape(2 * k, tile)),
        t_slot=dset(state.t_slot, new_t_slot.reshape(2 * k, tile)),
        g_ls=dset(state.g_ls, pair_ls),
        g_n=dset(state.g_n, pair_n),
        g_cent=dset(state.g_cent, pair_cent.astype(_CENT_DT)),
        g_pops=dset(state.g_pops, jnp.sum(pair_cent.astype(jnp.int32), -1)),
        g_count=dset(state.g_count, pair_counts),
        g_num=state.g_num + jnp.sum(active.astype(jnp.int32)),
    )


def _scan_fit_packed_impl(
    state: BatchState,
    dev_fps: Array,  # (R, F8) uint8 HBM-resident, R % m == 0, R >= start+k*m
    start: Array,  # () int32 row offset of the first batch
    n_valid: Array,  # () int32 valid rows from ``start`` (rest = padding)
    threshold: Array,
    tolerance: Array,
    *,
    k: int,
    m: int,
    n_features: int,
    criterion: str,
    block: int,
    max_rounds: int,
    narrow: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, Array, Array]:
    r"""Insert ``k`` consecutive batches of ``m`` rows in ONE dispatch.

    The host control plane's per-batch work (slice+prep dispatch, step
    dispatch, split dispatch) collapses into a single ``lax.scan`` program:
    body = slice+unpack -> batch step -> top-K split pass.  This is what
    makes throughput independent of host load — on a busy host a
    per-batch python driver starves the device, while one dispatch per k*m
    rows leaves the host only the enc pull at each flush boundary.

    Returns (state, assigned (k, m), encs (k,)).  Trailing all-padding
    batches exit their round loop immediately (cheap).
    """

    def body(state, i):
        rows = _slice_prep_fp_rows_impl(
            dev_fps, start + i * m,
            jnp.clip(n_valid - i * m, 0, m), m, n_features,
        )
        state, assigned, enc = _batch_step_impl(
            state, *rows, threshold, tolerance, criterion=criterion,
            block=block, max_rounds=max_rounds, narrow=narrow,
        )
        # Per-batch split pass whenever a group exceeds fanout (rebalancing
        # MATTERS FOR QUALITY in the merge-heavy regime: overflow chunk
        # groups fragment a hot group's candidate tile, rows stop seeing
        # the cluster they belong to and create duplicates — deferring
        # splits to the window tail measured +6.8% clusters at 1M t=0.3).
        # The near-full OR-term also fires between window tails so tiles
        # rarely overflow at all.  The cond's identity branch is cheap
        # relative to the split program only because XLA aliases the
        # untouched tables; kept for the regimes where groups stay
        # small.
        g_cap = state.g_count.shape[0]
        live = lax.broadcasted_iota(jnp.int32, (g_cap, 1), 0)[:, 0] < state.g_num
        counts = jnp.where(live, state.g_count, 0)
        tile_cap = state.t_pk.shape[1]
        near_full = jnp.any(counts > jnp.int32(tile_cap - 16))
        do_split = near_full | ((i == k - 1) & jnp.any(counts > fanout))
        state = lax.cond(
            do_split,
            lambda s: _split_topk_impl(s, k=split_k, fanout=fanout)[0],
            lambda s: s,
            state,
        )
        return state, (assigned, enc)

    state, (assigned, encs) = lax.scan(
        body, state, jnp.arange(k, dtype=jnp.int32)
    )
    return state, assigned, encs


_scan_fit_packed = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "n_features", "criterion", "block", "max_rounds",
        "narrow", "split_k", "fanout",
    ),
    donate_argnums=(0,),
)(_scan_fit_packed_impl)


@jax.jit
def _max_group_count(state: BatchState) -> Array:
    r"""Scalar pre-check for the split pass (one cheap device->host pull)."""
    return jnp.max(state.g_count)


@functools.partial(jax.jit, static_argnames=("chunk", "n_features"))
def _reconstruct_ls_chunk(
    state: BatchState, start: Array | int, chunk: int, n_features: int
) -> Array:
    r"""Dense linear sums of cluster slots [start, start+chunk)."""
    slots = start + lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
    slots = jnp.minimum(slots, state.n.shape[0] - 1)
    return _cluster_ls_of(state, slots, n_features)


def _slice_prep_fp_rows_impl(
    dev_fps: Array, start: Array, n_valid: Array, m: int, n_features: int
):
    r"""Fused dynamic-slice + unpack + CF-row prep for HBM-resident fps.

    One compiled program for every batch offset (python ``arr[a:b]`` slicing
    would specialize a new program per offset).  ``dev_fps`` must already be
    padded to a multiple of ``m`` rows.
    """
    packed = lax.dynamic_slice_in_dim(dev_fps, start, m, axis=0)
    rank = lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    valid = rank < n_valid
    bits = unpack_fingerprints_device(packed, n_features)
    row_ls = jnp.where(valid[:, None], bits.astype(jnp.int32), 0)
    row_n = valid.astype(jnp.int32)
    row_cent = row_ls.astype(_CENT_DT)
    row_pk = jnp.where(valid[:, None], packed, 0)
    row_pop = jnp.sum(row_ls, axis=-1)
    return row_ls, row_n, row_cent, row_pk, row_pop


_slice_prep_fp_rows = functools.partial(
    jax.jit, static_argnames=("m", "n_features")
)(_slice_prep_fp_rows_impl)


@functools.partial(jax.jit, static_argnames=("window",))
def _stage_tail(dev_fps: Array, n_valid: Array, window: int) -> Array:
    r"""Stage the trailing ``n_valid`` rows of a device-resident input into
    a fresh ``window``-row buffer (rows first, zero-padded) so the final
    partial window's batch slices stay in bounds without padding the whole
    staged input (which would cost a 2x HBM copy and an extra hot-path
    program)."""
    chunk = lax.dynamic_slice_in_dim(
        dev_fps, dev_fps.shape[0] - window, window, axis=0
    )
    rolled = jnp.roll(chunk, n_valid - window, axis=0)
    rank = lax.broadcasted_iota(jnp.int32, (window, 1), 0)[:, 0]
    return jnp.where((rank < n_valid)[:, None], rolled, 0)


@functools.partial(jax.jit, static_argnames=("n_features",))
def _prep_fp_rows(packed: Array, valid: Array, n_features: int):
    r"""Device-side CF-row prep from packed fingerprints (n = 1 rows)."""
    bits = unpack_fingerprints_device(packed, n_features)
    row_ls = bits.astype(jnp.int32)
    row_n = valid.astype(jnp.int32)
    row_cent = bits.astype(_CENT_DT)
    row_pop = jnp.sum(row_ls, axis=-1)
    return row_ls, row_n, row_cent, packed, row_pop


@jax.jit
def _prep_buffer_rows(row_ls: Array, row_n: Array):
    r"""Device-side CF-row prep from pre-aggregated buffers."""
    cent = majority_centroid_from_sums(row_ls, jnp.maximum(row_n, 1))
    row_pk = pack_fingerprints_device(cent)
    row_pop = jnp.sum(cent.astype(jnp.int32), axis=-1)
    return row_ls, row_n, cent.astype(_CENT_DT), row_pk, row_pop


@functools.partial(jax.jit, static_argnames=("n_features", "block"))
def _predict_step(
    state: BatchState,
    packed: Array,  # (M, F8) uint8 query rows
    valid: Array,  # (M,) bool
    *,
    n_features: int,
    block: int,
) -> tuple[Array, Array]:
    r"""Read-only nearest-cluster probe: route each query to its best group
    (matmul over routing centroids) and score that group's packed tile."""
    bits = unpack_fingerprints_device(packed, n_features)
    row_cent = bits.astype(_CENT_DT)
    row_pop = jnp.sum(bits.astype(jnp.int32), axis=-1)
    row_group = _route_groups(
        row_cent, row_pop, state.g_cent, state.g_pops, state.g_num,
        valid, block,
    )
    best_sim, best_slot = _search_tiles(
        packed, row_pop, row_group, state.t_pk, state.t_pops,
        state.t_slot, valid,
    )
    return best_sim, jnp.where(best_sim > -1.5, best_slot, -1)


@jax.jit
def _pool_dead_rows(state: BatchState) -> Array:
    r"""``num_ls`` minus the live ``ls_ref`` count (see
    ``BatchTree.pool_dead_rows``)."""
    c_cap = state.n.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (c_cap, 1), 0)[:, 0]
    live = (iota < state.num) & (state.ls_ref >= 0)
    return state.num_ls - jnp.sum(live.astype(jnp.int32))


def _load_rows_by_mol(
    X: "np.ndarray | Path | str | tp.Sequence[Path]",
    mol_ids: list[int],
    initial_mol: int,
    input_is_packed: bool,
) -> tuple[np.ndarray, list[int]]:
    r"""(packed fingerprint rows, matching mol ids) for ``mol_ids``.

    File sequences require globally sorted indices, so the returned mol
    ids may be a permutation of the input.  Shared by ``BatchTree`` and
    ``ShardedForest`` refinement (reference flow reloads original
    fingerprints by molecule id, ``bblean/bitbirch.py:1224-1290``).
    """
    arr_idxs = [m - initial_mol for m in mol_ids]
    if isinstance(X, (Path, str)):
        rows = np.asarray(np.load(X, mmap_mode="r")[arr_idxs])
    elif isinstance(X, np.ndarray):
        rows = X[arr_idxs]
    else:  # sequence of .npy paths
        from bblean_tpu.fingerprints import _get_fingerprints_from_file_seq

        order = np.argsort(arr_idxs)
        rows = _get_fingerprints_from_file_seq(
            tp.cast(tp.Sequence[Path], X),
            [arr_idxs[i] for i in order],
        )
        mol_ids = [mol_ids[i] for i in order]
    rows = np.asarray(rows, dtype=np.uint8)
    if not input_is_packed:
        rows = np.packbits(rows, axis=-1)
    return rows, mol_ids


class BatchTree:
    r"""Host driver for the batched device engine (data plane on device,
    topology control plane on host).

    ``fanout`` bounds the clusters per group (split trigger); ``tile`` is the
    static per-group tile capacity (must exceed ``fanout`` by enough headroom
    for in-batch creations).
    """

    def __init__(
        self,
        n_features: int,
        *,
        threshold: float = 0.65,
        merge_criterion: str = "diameter",
        tolerance: float = 0.05,
        batch_size: int = 1024,
        fanout: int = 192,
        tile: int = 256,
        initial_capacity: int = 8192,
        ls_capacity: int | None = None,
        g_capacity: int | None = None,
        route_block: int = 1024,
        max_rounds: int = 24,
        pipeline_depth: int = 3,
        stage_windows: int = 8,
    ) -> None:
        if fanout >= tile:
            raise ValueError("fanout must be < tile (headroom for creations)")
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8
        self.threshold = threshold
        self.merge_criterion = merge_criterion
        self.tolerance = tolerance
        self.batch_size = batch_size
        self.fanout = fanout
        self.tile = tile
        self.route_block = route_block
        self.max_rounds = max_rounds
        self.capacity = _next_pow2(
            max(initial_capacity, 2 * batch_size + 1)
        )
        # Sparse linear-sum pool: only multi-member clusters hold a row.
        # Measured occupancy stays tiny in both regimes (17k rows at 10M
        # t=0.3, 2.6k at t=0.65 — a pool row is 8 KB of dense int32, so the
        # old capacity//4 default would burn 33 GB at 16M capacity); the
        # default is capped and the pool grows on demand like the others.
        self.ls_capacity = _next_pow2(
            ls_capacity
            if ls_capacity is not None
            else max(
                min(self.capacity // 4, 1 << 17), 2 * batch_size + 1
            )
        )
        self.split_k = 64  # oversized groups split per device dispatch
        # Batches fused into one scan dispatch by fit_packed.  The scan body
        # runs a split pass per batch, so a window is self-contained the way
        # a split_interval segment of single-batch dispatches used to be.
        self.scan_batches = 16
        # Group headroom: saturation packs ~fanout clusters per group, so
        # the true need is ~capacity/fanout with ~1.3x slack for split
        # halves and overflow chunks, plus one scan window's worth of
        # split/creation headroom (_scan_g_headroom — _ensure_capacity
        # demands that much free space before every window).  Tiles cost
        # g_capacity * tile * F/8 bytes — the dominant HBM term — so a
        # cluster-level worst case must never size this table; in-table
        # guards pend overflow rows and the flush boundary grows + retries.
        self.g_capacity = _next_pow2(
            g_capacity
            if g_capacity is not None
            else max(
                256,
                self.capacity * 13 // (10 * max(fanout, 1))
                + self._scan_g_headroom(),
            )
        )
        self.state = _init_state(
            self.capacity, self.g_capacity, tile, n_features,
            self.ls_capacity,
        )
        # Host-side upper bounds on the device counters (see _ensure_capacity)
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        # Process the deferred boundary (pending retries) every
        # `split_interval` batches — each flush syncs the pipeline with the
        # host; overflow chunking keeps un-split groups correct in between.
        # Labels do not depend on the value (re-tuning it for this device
        # is open work)
        self.split_interval = 8
        # Scan windows allowed in flight before the oldest boundary is
        # settled.  Popping the oldest blocks on window w-depth (long done
        # while w computes); deeper queues keep the device fed when the
        # host stalls between submits, at the cost of `depth` staged window
        # buffers (~32 MB each at 131k rows) kept alive.
        self.pipeline_depth = max(1, pipeline_depth)
        # Host inputs stage in chunks of `stage_windows` scan windows (one
        # bulk device_put each, sliced at a traced offset in-program like a
        # device-resident input): fewer, larger transfers amortize the
        # per-put cost over `stage_windows` windows of compute instead of
        # serializing one put per window against the scan dispatches.
        # Inputs of at most one window keep the window-sized staging
        # buffer (same compiled shapes as before).
        self.stage_windows = max(1, stage_windows)
        self._boundary_queue: list[dict] = []
        # Per-inserted-row slot assignments + mol bookkeeping (host side)
        self._row_slots: list[np.ndarray] = []
        self._row_mols: list[list[list[int]]] = []

    @property
    def num_clusters(self) -> int:
        num = int(self.state.num)
        self._num_upper = num
        return num

    @property
    def num_groups(self) -> int:
        g_num = int(self.state.g_num)
        self._g_upper = g_num
        return g_num

    @property
    def pool_dead_rows(self) -> int:
        r"""Leaked linear-sum pool rows (telemetry).

        In-step guards can kill a multi-member creation AFTER its pool ref
        was consumed by the allocation cumsum (the trade documented at the
        ``fits_g`` kill site: hole-free tile positions + contiguous
        surviving refs in exchange for a rare leaked row).  Slots are never
        freed, so every live ref belongs to a live slot and the dead count
        is exactly ``num_ls - #live refs``.  The count is already folded
        into capacity accounting (the device ``num_ls`` counter includes
        dead rows, and flush refreshes ``_ls_upper`` from it), so leaks can
        only cost pool growth, never corruption — this property makes that
        cost visible for long refine/recluster loops.
        """
        return int(_pool_dead_rows(self.state))

    def _scan_g_headroom(self) -> int:
        r"""Free group slots demanded before a scan window dispatches: 2x
        the window's split-pass creations plus a generous estimate of
        overflow-chunk creations (~4 per tile of rows)."""
        k, m = self.scan_batches, self.batch_size
        return 2 * k * (self.split_k + 4 * (m // self.tile + 4))

    def _ensure_capacity(
        self,
        incoming: int,
        g_incoming: int | None = None,
        p_incoming: int | None = None,
    ) -> None:
        r"""Grow tables if needed, using host-side upper bounds to avoid a
        device sync per batch (each round-trip drains the device queue);
        exact counts are pulled only near the capacity edge.

        ``g_incoming``/``p_incoming`` bound the group/pool-row creations of
        the next dispatch separately from the cluster creations — groups
        cost ``tile * F/8`` tile bytes each, so sizing the group table for
        a cluster-level worst case (every row a fresh group) would waste
        GiBs of HBM.  Underestimates are safe: the step's in-table guards
        leave unplaceable rows pending and the flush boundary grows+retries.
        """
        if g_incoming is None:
            g_incoming = incoming
        if p_incoming is None:
            p_incoming = incoming
        # +1: the top slot of each table is a scatter guard and stays free.
        if self._num_upper + incoming + 1 > self.capacity:
            self._num_upper = int(self.state.num)  # sync the true count
        if self._g_upper + g_incoming + 1 > self.g_capacity:
            self._g_upper = int(self.state.g_num)
        if self._ls_upper + p_incoming + 1 > self.ls_capacity:
            self._ls_upper = int(self.state.num_ls)
        need_c = self._num_upper + incoming + 1
        need_g = self._g_upper + g_incoming + 1
        need_p = self._ls_upper + p_incoming + 1
        new_c, new_g = self.capacity, self.g_capacity
        new_p = self.ls_capacity
        while new_c < need_c:
            new_c *= 2
        while new_g < need_g:
            new_g *= 2
        while new_p < need_p:
            new_p *= 2
        if (new_c, new_g, new_p) != (
            self.capacity, self.g_capacity, self.ls_capacity
        ):
            self.state = jax.device_put(
                _grow_state(self.state, new_c, new_g, new_p)
            )
            self.capacity, self.g_capacity = new_c, new_g
            self.ls_capacity = new_p

    # -- insertion -----------------------------------------------------------

    def fit_packed(
        self, packed_fps: np.ndarray | Array, mol_indices: tp.Sequence[int]
    ) -> None:
        r"""Insert packed fingerprints — the fast path for large datasets.

        Inserts run as fused SCAN WINDOWS of ``scan_batches`` batches: one
        jitted dispatch covers slice+unpack, the insert rounds and the
        split pass for every batch in the window, so the host's only
        per-window work is bookkeeping plus one enc pull at the (pipelined)
        flush boundary — throughput no longer depends on host load.

        Device-resident inputs are sliced in HBM; host arrays are uploaded
        window-by-window one window ahead so transfers overlap the scans.
        """
        num = len(packed_fps)
        if num and packed_fps.shape[-1] != self.n_bytes:
            raise ValueError(
                f"packed rows have {packed_fps.shape[-1]} bytes, expected "
                f"{self.n_bytes} for {self.n_features} features (already-"
                "packed input passed through packbits again is the usual "
                "cause; make_fake_fingerprints returns PACKED rows)"
            )
        # Singleton rows: store mol ids as one flat array per window instead
        # of N one-element python lists (which cost seconds at 500k+ scale)
        mol_arr = np.fromiter(mol_indices, dtype=np.int64, count=num)
        m = self.batch_size
        k = self.scan_batches
        window = k * m
        on_device = isinstance(packed_fps, jax.Array)
        if on_device and num < window:
            # Rare small device input: pad once so the single window's
            # slices stay in bounds
            packed_fps = jnp.pad(packed_fps, ((0, window - num), (0, 0)))
        if not on_device and not isinstance(packed_fps, np.ndarray):
            packed_fps = np.asarray(packed_fps)

        # Device-resident inputs are never padded in place (a pad is a 2x
        # HBM copy of the whole input plus an extra compiled program in the
        # hot path).  Full windows slice the staged array directly —
        # trailing all-invalid batches read clamped rows, masked by the
        # valid prefix — and a final partial window stages its rows into a
        # small window-sized buffer so its partial batch stays in bounds.
        # Batch composition (hence labels) is identical to the host path.
        tail_buf = None
        if on_device and num > window and num % window:
            tail_buf = _stage_tail(
                packed_fps, jnp.int32(num % window), window
            )

        # Chunked host staging: one bulk device_put per `stage_windows`
        # windows, each window slicing the staged chunk at a traced offset
        # (exactly like the device-resident path).  A full chunk is a
        # contiguous view of the input — no host pad/copy; only the final
        # partial chunk pays one.  Exactly TWO buffer shapes exist (jit
        # specializes on them): single-window inputs keep the window-sized
        # buffer (the same compiled shape as the per-window staging this
        # replaces), everything larger uses the full chunk — a short final
        # chunk transfers some zero padding, bounded by one chunk and far
        # cheaper than a per-size program compile.
        n_windows = -(-num // window) if num else 1
        chunk_rows = (1 if n_windows <= 1 else self.stage_windows) * window

        def upload_chunk(cstart: int) -> Array | None:
            stop = min(cstart + chunk_rows, num)
            if stop <= cstart:
                return None
            chunk = packed_fps[cstart:stop]
            if stop - cstart < chunk_rows:
                chunk = np.pad(
                    chunk, ((0, chunk_rows - (stop - cstart)), (0, 0))
                )
            return jax.device_put(np.ascontiguousarray(chunk))

        cur_chunk = None if on_device else upload_chunk(0)
        nxt_chunk: Array | None = None
        for start in range(0, num, window):
            stop = min(start + window, num)
            n_valid = stop - start
            if on_device:
                if tail_buf is not None and n_valid < window:
                    dev_buf, dev_start = tail_buf, 0
                else:
                    dev_buf, dev_start = packed_fps, start
            else:
                coff = start % chunk_rows
                if start and coff == 0:
                    cur_chunk = (
                        nxt_chunk
                        if nxt_chunk is not None
                        else upload_chunk(start)
                    )
                    nxt_chunk = None
                dev_buf, dev_start = cur_chunk, coff
            self._submit_scan(
                dev_buf, dev_start, n_valid, mol_arr[start:stop]
            )
            if not on_device and nxt_chunk is None:
                # Prefetch the next chunk right after the current chunk's
                # first window dispatches: the (possibly blocking) transfer
                # overlaps the in-flight windows' compute
                nxt_chunk = upload_chunk(
                    (start // chunk_rows + 1) * chunk_rows
                )
        self.flush()

    def warm_programs(self, dev_fps: Array) -> None:
        r"""Execute the retry-path programs once with no-op inputs.

        The flush-boundary retry path (`_slice_prep_fp_rows` + the
        single-batch `_batch_step`) only runs when a window exhausts
        ``max_rounds`` — rare, data-dependent, and expensive to hit for the
        first time mid-run on backends where program load costs seconds.
        Benchmarks and latency-sensitive callers warm them here; all calls
        are mass-less (zero valid rows), so the tree state is unchanged.

        Also runs ``max(2, pipeline_depth)`` zero-valid scan windows
        through this tree's own
        state buffers: the first two windows of a fresh tree otherwise pay
        the per-tree device allocation + donation churn, which has nothing
        to do with the clustering work — the mass-less windows walk the
        same donation chain and leave the allocator warm.  ``dev_fps`` must hold at least
        ``scan_batches * batch_size`` rows.
        """
        m = self.batch_size
        rows = _slice_prep_fp_rows(
            dev_fps, jnp.int32(0), jnp.int32(0), m, self.n_features
        )
        self.state, _assigned, _enc = _batch_step(
            self.state, *rows, jnp.float32(self.threshold),
            jnp.float32(self.tolerance), criterion=self.merge_criterion,
            block=self.route_block, max_rounds=self.max_rounds,
            narrow=m // 4,
        )
        self._split_oversized_groups()
        for _ in range(max(2, self.pipeline_depth)):
            self.state, _a, _e = _scan_fit_packed(
                self.state, dev_fps, jnp.int32(0), jnp.int32(0),
                jnp.float32(self.threshold), jnp.float32(self.tolerance),
                k=self.scan_batches, m=m, n_features=self.n_features,
                criterion=self.merge_criterion, block=self.route_block,
                max_rounds=self.max_rounds,
                narrow=m // 4,
                split_k=self.split_k, fanout=self.fanout,
            )
        jax.block_until_ready(self.state.n)

    def _submit_scan(
        self,
        dev_fps: Array,
        start_row: int,
        n_valid: int,
        mols: np.ndarray,
    ) -> None:
        r"""Dispatch one fused k-batch scan window without a device sync."""
        m, k = self.batch_size, self.scan_batches
        # p_incoming=0: pool allocations are guarded IN-STEP (overflow rows
        # pend and the flush grows + retries), so the host never reserves
        # worst-case pool space — a k*m reservation forced a
        # pipeline-draining counter sync every other window
        self._ensure_capacity(
            k * m, g_incoming=self._scan_g_headroom(), p_incoming=0
        )
        self.state, assigned, encs = _scan_fit_packed(
            self.state, dev_fps, jnp.int32(start_row), jnp.int32(n_valid),
            jnp.float32(self.threshold), jnp.float32(self.tolerance),
            k=k, m=m, n_features=self.n_features,
            criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds,
            narrow=m // 4, split_k=self.split_k, fanout=self.fanout,
        )
        self._num_upper += n_valid
        # _ls_upper intentionally not advanced: the in-step pool guard
        # makes over-allocation impossible and flush() refreshes the bound
        self._g_upper += k * self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._row_slots.append((assigned.reshape(-1), n_valid))
        self._row_mols.append(mols)
        self._boundary_queue.append(
            {
                "kind": "scan",
                "slot_idx": len(self._row_slots) - 1,
                "dev_fps": dev_fps,
                "start": start_row,
                "n_valid": n_valid,
                "enc": encs,
                # Sync payload captured AT SUBMIT TIME: pulling it later
                # waits only for THIS window's program, not for whatever
                # was dispatched afterwards.  Piggybacks the true table
                # counters on the same fetch (refreshing the host's upper
                # bounds is free here, while letting them drift makes
                # _ensure_capacity take its own pipeline-draining sync).
                "sync": jnp.concatenate(
                    [
                        encs,
                        jnp.stack(
                            [
                                self.state.num,
                                self.state.g_num,
                                self.state.num_ls,
                            ]
                        ),
                    ]
                ),
            }
        )
        # Keep up to `pipeline_depth` windows in flight: popping ONLY the
        # oldest entry blocks on a window that finished while newer ones
        # compute, so the device never drains — a full flush here would
        # block on window w itself
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def insert_fps(
        self, unpacked_fps: np.ndarray, mol_indices: tp.Sequence[int]
    ) -> None:
        r"""Insert unpacked 0/1 fingerprints (one CF row of n=1 each)."""
        self.fit_packed(np.packbits(
            np.asarray(unpacked_fps, dtype=np.uint8), axis=-1
        ), mol_indices)

    def insert_buffers(
        self,
        buffers: np.ndarray,
        mol_index_seqs: tp.Sequence[tp.Sequence[int]],
    ) -> None:
        r"""Insert pre-aggregated CF buffers ``[linear_sum..., n]``."""
        ls = np.asarray(buffers)[:, :-1].astype(np.int32)
        ns = np.asarray(buffers)[:, -1].astype(np.int32)
        mols = [list(s) for s in mol_index_seqs]
        m = self.batch_size
        for start in range(0, len(ls), m):
            stop = min(start + m, len(ls))
            chunk_ls = ls[start:stop]
            chunk_n = ns[start:stop]
            pad = m - (stop - start)
            if pad:
                chunk_ls = np.pad(chunk_ls, ((0, pad), (0, 0)))
                chunk_n = np.pad(chunk_n, (0, pad))
            rows = _prep_buffer_rows(
                jnp.asarray(chunk_ls), jnp.asarray(chunk_n)
            )
            self._submit_batch(rows, mols[start:stop], chunk_n > 0)
        self.flush()

    def _submit_batch(
        self,
        rows: tuple[Array, ...],
        mols: "np.ndarray | list[list[int]]",
        host_valid: np.ndarray,
    ) -> None:
        r"""Dispatch one batch without any device->host sync.

        Pending-row checks and split passes are deferred to boundaries every
        ``split_interval`` batches (each sync drains the device queue); rows
        that exhausted their in-step rounds are retried at the boundary
        against the then-current state.
        """
        m = self.batch_size
        self._ensure_capacity(m)
        self.state, assigned, enc = _batch_step(
            self.state, *rows,
            jnp.float32(self.threshold), jnp.float32(self.tolerance),
            criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds,
            narrow=self.batch_size // 4,
        )
        n_valid = int(host_valid.sum())
        self._num_upper += n_valid
        self._ls_upper += n_valid  # promotions + pooled creations <= rows
        # Creations open at most ceil(n/tile) densely-packed chunk groups per
        # routed group; in-step clamping pends anything beyond capacity, so
        # this loose bound is safe
        self._g_upper += max(16, 4 * (n_valid // self.tile + 1))
        self._row_slots.append((assigned, len(mols)))
        self._row_mols.append(mols)
        self._boundary_queue.append(
            {
                "slot_idx": len(self._row_slots) - 1,
                "rows": rows,
                "host_valid": host_valid,
                "enc": enc,
            }
        )
        # One sync-free top-K split pass per batch: saturated groups
        # (count >= tile) otherwise shed a near-empty overflow chunk group
        # every batch, fragmenting tile occupancy (measured 17% at 1M
        # fps @ t=0.65 with splits every 4th batch)
        self._split_oversized_groups()
        if len(self._boundary_queue) >= self.split_interval:
            self.flush()

    def flush(self) -> None:
        r"""Drain every deferred boundary, then a final split pass."""
        while self._boundary_queue:
            self._process_oldest_boundary()
        self._split_oversized_groups()

    def _process_oldest_boundary(self) -> None:
        r"""Pop and settle the OLDEST deferred boundary entry.

        For scan windows the pull reads the entry's submit-time ``sync``
        payload, so it blocks only on that window's program — newer
        windows already dispatched keep the device busy during the pull
        (true depth-2 pipelining; draining the whole queue here instead
        idles the device while the host settles each boundary).
        """
        q = self._boundary_queue.pop(0)
        k = self.scan_batches
        if "sync" in q:
            flat = np.asarray(q["sync"])  # blocks on THIS window only
            pending = flat[:-3] // 1000
            # True table counters as of this window, plus the worst-case
            # contributions of the newer windows still in flight
            extra_rows = sum(
                q2["n_valid"] for q2 in self._boundary_queue
            )
            extra_g = sum(
                k * self.split_k
                + max(16, 4 * (q2["n_valid"] // self.tile + 1))
                for q2 in self._boundary_queue
            )
            self._num_upper = int(flat[-3]) + extra_rows
            self._g_upper = int(flat[-2]) + extra_g
            # Pool bound: in-flight windows are NOT charged per-row — the
            # in-step pool guard pends rows on exhaustion (survivable), and
            # charging extra_rows here put the bound past ls_capacity at
            # every pop whenever a window exceeded the pool size (131k-row
            # windows vs a 64k pool at 10M), turning the capacity-edge
            # sync into a pipeline drain per window.
            # Charge the same 2*m margin the proactive refresh demands.
            self._ls_upper = int(flat[-1]) + 2 * self.batch_size * len(
                self._boundary_queue
            )
            # Proactive pool headroom while the counters are fresh (sync-
            # free here): mid-cycle pool exhaustion is survivable (the
            # in-step guard pends rows) but costs retry dispatches
            self._ensure_capacity(
                0, g_incoming=0, p_incoming=2 * self.batch_size
            )
            if (pending > 0).any():
                self._retry_scan(q, pending)
                self._split_oversized_groups()
        else:
            enc = int(np.asarray(q["enc"]))
            if enc // 1000 > 0:
                self._retry_batch(q)
                self._split_oversized_groups()

    def _retry_batch(self, q: dict) -> None:
        r"""Drain a batch whose step exhausted max_rounds (rare): split, mask
        the already-assigned rows, re-step until done."""
        row_ls, row_n, row_cent, row_pk, row_pop = q["rows"]
        host_valid = q["host_valid"]
        assigned_dev, count = self._row_slots[q["slot_idx"]]
        final_assigned = np.array(np.asarray(assigned_dev))
        for _attempt in range(64):
            missing = (final_assigned == -1) & host_valid
            if not missing.any():
                break
            # The retry loop syncs anyway, so fully drain oversized groups
            self._split_oversized_groups(drain=True)
            row_n = jnp.where(jnp.asarray(missing), row_n, 0)
            self._ensure_capacity(self.batch_size)
            self.state, assigned, _enc = _batch_step(
                self.state, row_ls, row_n, row_cent, row_pk, row_pop,
                jnp.float32(self.threshold), jnp.float32(self.tolerance),
                criterion=self.merge_criterion, block=self.route_block,
                max_rounds=self.max_rounds,
                narrow=self.batch_size // 4,
            )
            self._num_upper += int(missing.sum())
            self._g_upper += int(missing.sum())
            self._ls_upper += int(missing.sum())
            assigned_np = np.asarray(assigned)
            final_assigned[missing] = assigned_np[missing]
        else:
            raise RuntimeError("batch engine failed to drain a batch")
        self._row_slots[q["slot_idx"]] = (final_assigned, count)

    def _retry_scan(self, q: dict, pending_per_batch: np.ndarray) -> None:
        r"""Drain a scan window some of whose batches exhausted max_rounds
        (rare): split, rebuild each pending batch's rows from the staged
        fps, mask the already-assigned rows and re-step until done."""
        m, k = self.batch_size, self.scan_batches
        assigned_dev, n_valid = self._row_slots[q["slot_idx"]]
        final = np.array(np.asarray(assigned_dev))
        valid = np.zeros(k * m, bool)
        valid[:n_valid] = True
        for i in range(k):
            if pending_per_batch[i] <= 0:
                continue
            seg = slice(i * m, (i + 1) * m)
            seg_final = final[seg]
            seg_valid = valid[seg]
            for _attempt in range(64):
                missing = (seg_final == -1) & seg_valid
                if not missing.any():
                    break
                self._split_oversized_groups(drain=True)
                rows = _slice_prep_fp_rows(
                    q["dev_fps"],
                    q["start"] + i * m,
                    max(0, min(m, q["n_valid"] - i * m)),
                    m,
                    self.n_features,
                )
                row_ls, row_n, row_cent, row_pk, row_pop = rows
                row_n = jnp.where(jnp.asarray(missing), row_n, 0)
                self._ensure_capacity(m)
                self.state, assigned, _enc = _batch_step(
                    self.state, row_ls, row_n, row_cent, row_pk, row_pop,
                    jnp.float32(self.threshold),
                    jnp.float32(self.tolerance),
                    criterion=self.merge_criterion, block=self.route_block,
                    max_rounds=self.max_rounds,
                    narrow=self.batch_size // 4,
                )
                n_miss = int(missing.sum())
                self._num_upper += n_miss
                self._g_upper += n_miss
                self._ls_upper += n_miss
                assigned_np = np.asarray(assigned)
                seg_final[missing] = assigned_np[missing]
            else:
                raise RuntimeError("batch engine failed to drain a window")
            final[seg] = seg_final
        self._row_slots[q["slot_idx"]] = (final, n_valid)

    # -- host control plane: group splits ------------------------------------

    def _split_oversized_groups(self, drain: bool = False) -> None:
        r"""Split groups whose cluster count exceeds ``fanout``.

        Selection AND split (seed pair, balanced partition, tile re-pack,
        CF bookkeeping) run entirely on device in one top-K dispatch per
        pass — the host never pulls ``g_count`` (every pull syncs the whole
        queued pipeline).  The steady state runs one
        pass per boundary: groups beyond the top K stay correct through
        overflow chunking and are caught at the next boundary.  ``drain``
        loops until nothing is oversized (used when a sync happens anyway).
        """
        k = self.split_k  # splits per device call (static shape)
        for _ in range(64):
            self._ensure_capacity(k)
            self.state, n_left = _split_topk_device(
                self.state, k=k, fanout=self.fanout
            )
            self._g_upper += k
            if not drain or int(n_left) <= 0:
                return

    # -- refinement ----------------------------------------------------------

    def reset(
        self,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
    ) -> None:
        r"""Drop all clusters (device state + host bookkeeping), optionally
        switching the merge criterion/threshold for the next fit."""
        if threshold is not None:
            self.threshold = threshold
        if merge_criterion is not None:
            self.merge_criterion = merge_criterion
        if tolerance is not None:
            self.tolerance = tolerance
        self.state = _init_state(
            self.capacity, self.g_capacity, self.tile, self.n_features,
            self.ls_capacity,
        )
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        self._boundary_queue = []
        self._row_slots = []
        self._row_mols = []

    def _load_rows_by_mol(
        self,
        X: "np.ndarray | Path | str | tp.Sequence[Path]",
        mol_ids: list[int],
        initial_mol: int,
        input_is_packed: bool,
    ) -> tuple[np.ndarray, list[int]]:
        return _load_rows_by_mol(X, mol_ids, initial_mol, input_is_packed)

    def refine_inplace(
        self,
        X: "np.ndarray | Path | str | tp.Sequence[Path]",
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
    ) -> "BatchTree":
        r"""Explode the ``n_largest`` clusters into singletons and re-fit.

        Mirrors the exact engine's refinement (reference flow
        ``bblean/bitbirch.py:1187-1214``): surviving clusters re-insert as
        pre-aggregated CF buffers largest-first, then the exploded rows
        re-insert as singletons (their original fingerprints are reloaded
        from ``X`` by molecule id).
        """
        if n_largest < 0:
            raise ValueError("n_largest must be >= 0")
        sizes = self.cluster_sizes()
        ls = self.linear_sums()
        mols = self.cluster_mols()
        order = np.argsort(-sizes, kind="stable")
        big, rest = order[:n_largest], order[n_largest:]

        exploded_mols = [m for i in big for m in mols[i]]
        rows, row_mols = self._load_rows_by_mol(
            X, exploded_mols, initial_mol, input_is_packed
        )

        buffers = np.concatenate(
            [ls[rest], sizes[rest, None]], axis=1, dtype=np.int64
        )
        buffer_mols = [mols[i] for i in rest]

        self.reset(
            threshold=threshold,
            merge_criterion=merge_criterion,
            tolerance=tolerance,
        )
        if len(buffers):
            self.insert_buffers(buffers, buffer_mols)
        if len(rows):
            self.fit_packed(rows, row_mols)
        return self

    def recluster_inplace(
        self,
        iterations: int = 1,
        extra_threshold: float = 0.0,
        shuffle: bool = False,
        seed: int | None = None,
    ) -> "BatchTree":
        r"""Re-insert every cluster as a CF buffer, optionally shuffled,
        bumping the threshold by ``extra_threshold`` per iteration."""
        rng = np.random.default_rng(seed)
        for _ in range(iterations):
            sizes = self.cluster_sizes()
            ls = self.linear_sums()
            mols = self.cluster_mols()
            order = (
                rng.permutation(len(sizes))
                if shuffle
                else np.argsort(-sizes, kind="stable")
            )
            buffers = np.concatenate(
                [ls[order], sizes[order, None]], axis=1, dtype=np.int64
            )
            buffer_mols = [mols[i] for i in order]
            self.reset(threshold=self.threshold + extra_threshold)
            self.insert_buffers(buffers, buffer_mols)
        return self

    # -- extraction ----------------------------------------------------------

    def cluster_sizes(self) -> np.ndarray:
        self.flush()
        return np.asarray(self.state.n)[: self.num_clusters]

    def linear_sums(self) -> np.ndarray:
        r"""Dense (C, F) int32 linear sums, reconstructed from the sparse
        pool + singleton tile bits in device chunks."""
        self.flush()
        ncl = self.num_clusters
        out = np.empty((ncl, self.n_features), np.int32)
        chunk = 1 << 15
        for start in range(0, ncl, chunk):
            size = min(chunk, ncl - start)
            rows = _reconstruct_ls_chunk(
                self.state, start, chunk, self.n_features
            )
            out[start : start + size] = np.asarray(rows)[:size]
        return out

    def _materialize_slots(self) -> None:
        r"""Pull any deferred device-side assignment vectors in one batch
        (per length: scan windows and single batches stack separately)."""
        device_idx = [
            i for i, s in enumerate(self._row_slots)
            if not isinstance(s[0] if isinstance(s, tuple) else s, np.ndarray)
        ]
        by_len: dict[int, list[int]] = {}
        for i in device_idx:
            by_len.setdefault(int(self._row_slots[i][0].shape[0]), []).append(i)
        for idxs in by_len.values():
            stacked = np.asarray(
                jnp.stack([self._row_slots[i][0] for i in idxs])
            )
            for row, i in enumerate(idxs):
                _, count = self._row_slots[i]
                self._row_slots[i] = (stacked[row], count)
        self._row_slots = [
            (np.asarray(s[0])[: s[1]], s[1]) if isinstance(s, tuple) else s
            for s in self._row_slots
        ]

    def _flat_assignments(self) -> tuple[np.ndarray, np.ndarray]:
        r"""(mol ids, cluster slot per mol) over every inserted row, in
        insertion order — the vectorized form of the mol bookkeeping."""
        self.flush()
        self._materialize_slots()
        mol_parts: list[np.ndarray] = []
        slot_parts: list[np.ndarray] = []
        for (slots, _count), mols in zip(self._row_slots, self._row_mols):
            if isinstance(mols, np.ndarray):  # singleton rows, flat ids
                mol_parts.append(mols)
                slot_parts.append(slots)
            else:  # buffer rows: one list of mol ids per row
                lens = np.fromiter(
                    (len(ml) for ml in mols), dtype=np.int64, count=len(mols)
                )
                if lens.sum() == 0:
                    continue
                mol_parts.append(
                    np.concatenate([np.asarray(ml, np.int64) for ml in mols if ml])
                )
                slot_parts.append(np.repeat(slots[: len(mols)], lens))
        if not mol_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return (
            np.concatenate(mol_parts),
            np.concatenate(slot_parts).astype(np.int64, copy=False),
        )

    def assignments(self) -> np.ndarray:
        r"""Cluster slot per molecule id, as one int array (0-based slots;
        the cheap extraction path at 10M+ scale)."""
        mols, slots = self._flat_assignments()
        out = np.full(int(mols.max()) + 1 if len(mols) else 0, -1, np.int64)
        out[mols] = slots
        return out

    def cluster_mols(self) -> list[list[int]]:
        r"""Molecule ids per cluster slot (slot order, not size order).

        Vectorized: one stable argsort over all (slot, mol) pairs plus a
        per-cluster slice, instead of a Python append per row (which costs
        minutes at 10M rows).
        """
        ncl = self.num_clusters
        mols, slots = self._flat_assignments()
        if not len(mols):
            return [[] for _ in range(ncl)]
        order = np.argsort(slots, kind="stable")  # keeps insertion order
        mols_sorted = mols[order]
        slots_sorted = slots[order]
        bounds = np.searchsorted(
            slots_sorted, np.arange(ncl + 1), side="left"
        ).tolist()
        # One C-level tolist over all rows, then plain list slices per
        # cluster: per-cluster ndarray slicing + tolist costs ~2-3 us of
        # numpy dispatch each, which is ~20 s of pure interpreter time at
        # 10M rows / 4M clusters — the flat path does the same job in <5 s
        flat = mols_sorted.tolist()
        return [flat[bounds[i] : bounds[i + 1]] for i in range(ncl)]

    def packed_centroids(self) -> np.ndarray:
        r"""Majority-vote centroids of all clusters, packed uint8."""
        ls = self.linear_sums()
        n = self.cluster_sizes()
        cent = np.where(
            (n > 1)[:, None], ls >= (n[:, None] * 0.5), np.clip(ls, 0, 1)
        ).astype(np.uint8)
        return np.packbits(cent, axis=-1)

    def predict_packed(
        self, packed_fps: np.ndarray, *, batch: int = 8192
    ) -> tuple[np.ndarray, np.ndarray]:
        r"""Nearest-cluster probe for new (packed) fingerprints, read-only.

        Returns ``(slots, sims)``: the best cluster slot per query (same id
        space as :meth:`assignments`; -1 when the tree is empty) and the
        Tanimoto similarity to that cluster's centroid.  The depth-2 search
        the engine fits with: queries route to their best group, then score
        the group's packed tile — the device analogue of the reference
        sklearn adapter's ``predict`` (jaccard argmin over subcluster
        centers, ``bblean/sklearn.py:123-137``).
        """
        self.flush()
        num = len(packed_fps)
        slots = np.empty(num, np.int64)
        sims = np.empty(num, np.float64)
        for start in range(0, num, batch):
            chunk = np.asarray(packed_fps[start : start + batch])
            n_valid = len(chunk)
            if n_valid < batch:
                chunk = np.pad(chunk, ((0, batch - n_valid), (0, 0)))
            valid = np.zeros(batch, bool)
            valid[:n_valid] = True
            sim, slot = _predict_step(
                self.state, jnp.asarray(chunk), jnp.asarray(valid),
                n_features=self.n_features, block=self.route_block,
            )
            slots[start : start + n_valid] = np.asarray(slot)[:n_valid]
            sims[start : start + n_valid] = np.asarray(sim)[:n_valid]
        return slots, sims


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p
