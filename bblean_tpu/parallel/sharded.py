r"""SPMD sharded clustering on the BatchTree control plane.

Device re-design of the reference's multiround pipeline
(``bblean/multiround.py:333-484``): instead of worker processes exchanging
CF *files* bin-by-bin, a 1-D device mesh runs one batched CF-forest per
device and merges them with collectives over the device interconnect
(NVLink between the GPUs of one host, all to all, so the mesh shape follows
the algorithm alone).

**Fit phase** — inputs that fit ``resident_input_bytes`` upload ONCE as a
window-major resident buffer sharded over the mesh (full windows only — a
host-side pad of the whole input is never taken; a partial tail window
streams), and every window's ``shard_map`` dispatch slices its rows at a
traced offset INSIDE the fused scan program (slice+unpack -> insert
rounds -> split pass, ``engine/batch.py``) — the same in-program slicing
the single-chip ``BatchTree`` uses, so the host's per-window work is pure
bookkeeping.  Larger inputs stream through the host in
windows of ``n_devices * scan_batches * batch_size`` packed rows (one
window of prefetch), each placed so every device receives its contiguous
sub-block; both paths compose identical batches, so labels are identical.
No collectives run during the fit, per-device state is the same sparse
bounded structure ``BatchTree`` uses (packed tiles + sparse linear-sum
pool), and capacity grows on demand from cluster counts — per-device HBM
is bounded by the *clusters* a device discovers plus its input shard,
never by dense per-row tables (the round-2 design held dense
``(rows_per_device, F)`` tables and could not scale).

**Merge phase** — ``ceil(log2(D))`` reduction rounds (the reference's
midsection rounds over file pairs, ``multiround.py:427-456``).  Each round:

1. *Exchange*: one ``lax.ppermute`` ships the sender's whole sparse state
   (packed tiles, counts, pool) to its partner.
2. *Group-gated merge* (collective-free, per-device): the receiver routes
   every received GROUP against its own routing table (one matmul).
   Received groups with no similar own group — the common case for shard-
   local clusters — are **bulk-appended wholesale**: their tiles, CFs and
   pool rows are scattered into the receiver's tables as whole blocks, no
   per-row work.  Only received groups that closely match an own group
   (candidate cross-shard duplicates) have their member clusters re-inserted
   row-level through the batch-step rounds, largest-first (the
   uint16-before-uint8 ordering heuristic of ``multiround.py:104-111``).

The gate makes the merge cost proportional to the *actual cross-device
overlap* instead of the total cluster count: without it, a reduction over D
shards re-clusters ~C rows on the final device, which for singleton-heavy
regimes costs as much as the fit itself.  ``merge_gate_margin`` controls
the trade: the gate threshold is ``merge_threshold - margin``; a margin
>= 1 sends every group row-level (exact multiround-like behavior).

Labels are composed on host from the per-round assignment maps; own rows
never renumber (inserting received rows into an existing forest leaves
existing slots fixed), so only receiver-side maps are exchanged.
"""

from __future__ import annotations

import math
import typing as tp
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bblean_tpu.engine.batch import (
    _CENT_DT,
    BatchState,
    _batch_step_impl,
    _cluster_ls_of,
    _grow_state,
    _init_state,
    _intersections,
    _next_pow2,
    _reconstruct_ls_chunk,
    _scan_fit_packed_impl,
    _slice_prep_fp_rows_impl,
    _split_topk_impl,
)
from bblean_tpu.ops.divide import div_rn
from bblean_tpu.ops.isim import majority_centroid_from_sums
from bblean_tpu.ops.packing import pack_fingerprints_device

__all__ = ["sharded_fit", "ShardedClusters", "ShardedForest"]


class ShardedClusters(tp.NamedTuple):
    r"""Result of a sharded fit (host-side)."""

    labels: np.ndarray  # (N,) final cluster slot per input row
    linear_sums: np.ndarray  # (C, F) merged cluster linear sums
    sizes: np.ndarray  # (C,) merged cluster sizes
    num_clusters: int


@jax.jit
def _slice_window(resident: Array, w) -> Array:
    r"""One window's rows from the window-major resident input buffer.

    The window index is traced so every window reuses ONE compiled slice
    (a static ``resident[w]`` compiles + loads a fresh program per window,
    which costs more than the upload it replaces)."""
    return lax.dynamic_index_in_dim(resident, w, axis=0, keepdims=False)


def _sq(tree):
    r"""Strip the leading singleton axis shard_map leaves on a 1-D mesh."""
    return jax.tree.map(lambda x: x[0], tree)


def _ex(tree):
    r"""Re-add the leading singleton axis for shard_map outputs."""
    return jax.tree.map(lambda x: x[None], tree)


def _best_group_sim(
    q_cent: Array,  # (Q, F) int8 query centroids (0/1 values)
    q_pops: Array,  # (Q,) int32
    g_cent: Array,  # (G_cap, F) int8 (0/1 values)
    g_pops: Array,  # (G_cap,) int32
    g_num: Array,  # ()
    block: int,
) -> Array:
    r"""Max Tanimoto of each query centroid over the live groups (tiled
    matmul; the similarity twin of ``_route_groups``)."""
    q = q_cent.shape[0]
    g_cap = g_cent.shape[0]
    block = min(block, g_cap)
    n_blocks = (g_num + block - 1) // block

    def body(b, best):
        start = b * block
        cb = lax.dynamic_slice_in_dim(g_cent, start, block, axis=0)
        pb = lax.dynamic_slice_in_dim(g_pops, start, block, axis=0)
        inter = _intersections(q_cent, cb)
        union = (q_pops[:, None] + pb[None, :]).astype(jnp.float32) - inter
        sims = div_rn(inter, jnp.maximum(union, 1.0))
        cols = start + lax.broadcasted_iota(jnp.int32, (q, block), 1)
        sims = jnp.where(cols < g_num, sims, -2.0)
        return jnp.maximum(best, jnp.max(sims, axis=1))

    return lax.fori_loop(
        0, n_blocks, body, jnp.full((q,), -2.0, jnp.float32)
    )


def _insert_slots_impl(
    state: BatchState,
    recv: BatchState,
    ins_mask: Array,  # (C_cap,) bool: received slots to insert row-level
    amap: Array,  # (C_cap,) int32 assignment map (updated where assigned)
    threshold: Array,
    tolerance: Array,
    *,
    m_b: int,
    criterion: str,
    block: int,
    max_rounds: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, Array]:
    r"""Insert the masked received clusters into ``state`` as CF rows,
    largest-first, in ``m_b``-row batch steps with a split pass per batch.

    The batch loop has a DYNAMIC trip count (``ceil(n_ins / m_b)``), so the
    cost is proportional to the rows actually inserted — a receiver with a
    handful of cross-shard duplicates runs one or two batches regardless of
    table capacity.  Rows the step could not place keep ``amap == -1`` (the
    host grows capacity and retries).
    """
    c_cap = state.n.shape[0]
    n_features = state.g_ls.shape[1]
    # Largest-first among the masked slots; everything else sorts last
    nkey = jnp.where(ins_mask, -recv.n, jnp.int32(1 << 30))
    order = jnp.argsort(nkey, stable=True)
    order = jnp.pad(order, (0, m_b))  # slack for the last dynamic slice
    n_ins = jnp.sum(ins_mask.astype(jnp.int32))
    n_batches = (n_ins + m_b - 1) // m_b
    iota_b = lax.broadcasted_iota(jnp.int32, (m_b, 1), 0)[:, 0]

    def cond(carry):
        return carry[2] < n_batches

    def body(carry):
        state, amap, b = carry
        sel = lax.dynamic_slice_in_dim(order, b * m_b, m_b)
        valid = (b * m_b + iota_b) < n_ins
        row_ls = _cluster_ls_of(recv, sel, n_features)
        row_n = jnp.where(valid, recv.n[sel], 0)
        cent = majority_centroid_from_sums(row_ls, jnp.maximum(row_n, 1))
        row_pk = pack_fingerprints_device(cent)
        row_pop = jnp.sum(cent.astype(jnp.int32), axis=-1)
        state, assigned, _enc = _batch_step_impl(
            state, row_ls, row_n, cent.astype(_CENT_DT), row_pk,
            row_pop, threshold, tolerance, criterion=criterion,
            block=block, max_rounds=max_rounds, narrow=m_b // 4,
        )
        state, _ = _split_topk_impl(state, k=split_k, fanout=fanout)
        amap = amap.at[
            jnp.where(valid & (assigned >= 0), sel, c_cap)
        ].set(assigned, mode="drop", unique_indices=True)
        return state, amap, b + 1

    state, amap, _ = lax.while_loop(
        cond, body, (state, amap, jnp.int32(0))
    )
    return state, amap


def _merge_into_impl(
    state: BatchState,
    recv: BatchState,
    is_recv: Array,  # () bool: this device merges (senders no-op)
    gate: Array,  # () f32 group-similarity gate
    threshold: Array,
    tolerance: Array,
    *,
    m_b: int,
    criterion: str,
    block: int,
    max_rounds: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, Array]:
    r"""Merge a received forest into ``state`` (collective-free).

    Group-gated: received groups whose best own-group centroid similarity is
    below ``gate`` bulk-append (tiles move as whole blocks); the rest insert
    row-level through the batch-step rounds.  Returns the updated state and
    the (C_cap,) assignment map of received slot -> own slot (-1 where the
    slot was masked out or could not be placed yet).
    """
    c_cap = state.n.shape[0]
    g_cap = state.g_ls.shape[0]
    p_cap = state.ls.shape[0]
    tile = state.t_pk.shape[1]

    giota = lax.broadcasted_iota(jnp.int32, (g_cap, 1), 0)[:, 0]
    live_r = is_recv & (giota < recv.g_num) & (recv.g_count > 0)
    best_sim = _best_group_sim(
        recv.g_cent, recv.g_pops, state.g_cent, state.g_pops, state.g_num,
        block,
    )
    far = live_r & (best_sim < gate)
    close = live_r & (best_sim >= gate)

    # ---- bulk append far groups (whole tiles, no per-row work) ----
    far_i = far.astype(jnp.int32)
    new_gid = state.g_num + jnp.cumsum(far_i) - 1  # (G_cap,)
    g_idx = jnp.where(far, new_gid, g_cap)  # OOB drops inactive rows

    occ = recv.t_slot >= 0  # (G_cap, tile)
    cell_mask = (far[:, None] & occ).reshape(-1)
    cell_rank = jnp.cumsum(cell_mask.astype(jnp.int32)) - 1
    new_slot = state.num + cell_rank  # (G_cap * tile,)
    slot_src = jnp.maximum(recv.t_slot, 0).reshape(-1)
    src_ref = recv.ls_ref[slot_src]
    pooled = cell_mask & (src_ref >= 0)
    new_ref = state.num_ls + jnp.cumsum(pooled.astype(jnp.int32)) - 1

    tgt_slot = jnp.where(cell_mask, new_slot, c_cap)
    gid_cell = jnp.broadcast_to(new_gid[:, None], (g_cap, tile)).reshape(-1)
    pos_cell = jnp.broadcast_to(
        lax.broadcasted_iota(jnp.int32, (1, tile), 1), (g_cap, tile)
    ).reshape(-1)

    group = state.group.at[tgt_slot].set(
        gid_cell, mode="drop", unique_indices=True
    )
    pos = state.pos.at[tgt_slot].set(
        pos_cell, mode="drop", unique_indices=True
    )
    n = state.n.at[tgt_slot].set(
        recv.n[slot_src], mode="drop", unique_indices=True
    )
    ls_ref = state.ls_ref.at[tgt_slot].set(
        jnp.where(pooled, new_ref, -1), mode="drop", unique_indices=True
    )
    ls = state.ls.at[jnp.where(pooled, new_ref, p_cap)].set(
        recv.ls[jnp.maximum(src_ref, 0)], mode="drop", unique_indices=True
    )
    # Tiles copy wholesale; slot cells remap to the fresh slot ids
    remap_slot = jnp.where(
        occ, (state.num + cell_rank.reshape(g_cap, tile)), -1
    )
    t_pk = state.t_pk.at[g_idx].set(
        recv.t_pk, mode="drop", unique_indices=True
    )
    t_pops = state.t_pops.at[g_idx].set(
        recv.t_pops, mode="drop", unique_indices=True
    )
    t_slot = state.t_slot.at[g_idx].set(
        remap_slot, mode="drop", unique_indices=True
    )
    g_ls = state.g_ls.at[g_idx].set(
        recv.g_ls, mode="drop", unique_indices=True
    )
    g_n = state.g_n.at[g_idx].set(
        recv.g_n, mode="drop", unique_indices=True
    )
    g_cent = state.g_cent.at[g_idx].set(
        recv.g_cent, mode="drop", unique_indices=True
    )
    g_pops = state.g_pops.at[g_idx].set(
        recv.g_pops, mode="drop", unique_indices=True
    )
    g_count = state.g_count.at[g_idx].set(
        recv.g_count, mode="drop", unique_indices=True
    )

    amap = jnp.full((c_cap,), -1, jnp.int32).at[
        jnp.where(cell_mask, slot_src, c_cap)
    ].set(new_slot, mode="drop", unique_indices=True)

    state = BatchState(
        ls=ls,
        num_ls=state.num_ls + jnp.sum(pooled.astype(jnp.int32)),
        ls_ref=ls_ref,
        n=n,
        group=group,
        pos=pos,
        num=state.num + jnp.sum(cell_mask.astype(jnp.int32)),
        t_pk=t_pk,
        t_pops=t_pops,
        t_slot=t_slot,
        g_ls=g_ls,
        g_n=g_n,
        g_cent=g_cent,
        g_pops=g_pops,
        g_count=g_count,
        g_num=state.g_num + jnp.sum(far_i),
    )

    # ---- row-level insert the close groups' member clusters ----
    ciota = lax.broadcasted_iota(jnp.int32, (c_cap, 1), 0)[:, 0]
    ins_mask = (
        (ciota < recv.num) & (recv.n > 0) & close[recv.group]
    )
    state, amap = _insert_slots_impl(
        state, recv, ins_mask, amap, threshold, tolerance, m_b=m_b,
        criterion=criterion, block=block, max_rounds=max_rounds,
        split_k=split_k, fanout=fanout,
    )
    return state, amap


# -- device programs (module-level, shared across forest instances) ----------
#
# One ``jax.jit`` wrapper per (mesh, axis), NOT per forest: a per-instance
# jit re-traces and re-loads the executable for every fresh forest before
# its first window can run, while ``BatchTree``'s programs are module-level
# jits shared across trees.  ``Mesh`` hashes by devices + axis names, so
# the cache key is exact.


@lru_cache(maxsize=None)
def _fit_window_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit,
        static_argnames=(
            "k", "m", "n_features", "criterion", "block", "max_rounds",
            "narrow", "split_k", "fanout",
        ),
        donate_argnums=(0,),
    )
    def fit_window(
        state, dev_fps, n_valid, threshold, tolerance, *, k, m,
        n_features, criterion, block, max_rounds, narrow, split_k,
        fanout,
    ):
        def body(state, fps, nv, thr, tol):
            st, assigned, encs = _scan_fit_packed_impl(
                _sq(state), fps, jnp.int32(0), nv[0], thr, tol,
                k=k, m=m, n_features=n_features,
                criterion=criterion, block=block, max_rounds=max_rounds,
                narrow=narrow, split_k=split_k,
                fanout=fanout,
            )
            return _ex(st), assigned[None], encs[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(ax), P(ax), P(), P()),
            out_specs=(P(ax), P(ax), P(ax)),
            check_vma=False,
        )(state, dev_fps, n_valid, threshold, tolerance)

    return fit_window


@lru_cache(maxsize=None)
def _fit_resident_program_for(mesh: Mesh, ax: str):
    r"""Fused scan over a window of a RESIDENT window-major input.

    The whole ``(n_w, window, F8)`` buffer enters the shard_map (each
    device's block is its contiguous per-window rows) and the window
    index ``w`` is a traced scalar: the scan slices rows at offset
    ``w * scan_batches * batch_size`` INSIDE the program — the same
    traced-offset slicing ``BatchTree._submit_scan`` uses for device
    inputs.  This removes both the per-window host staging of the
    streamed path and a standalone slice dispatch that would serialize
    against the scan; one program compiles per distinct ``n_w``.
    """

    @partial(
        jax.jit,
        static_argnames=(
            "k", "m", "n_features", "criterion", "block", "max_rounds",
            "narrow", "split_k", "fanout",
        ),
        donate_argnums=(0,),
    )
    def fit_window_resident(
        state, resident, w, n_valid, threshold, tolerance, *, k, m,
        n_features, criterion, block, max_rounds, narrow, split_k,
        fanout,
    ):
        def body(state, res, w, nv, thr, tol):
            # res: (n_w, win_d, F8) device-local block — flattening
            # row-major puts window w's rows at offset w * win_d (a
            # free reshape; the scan's dynamic slice does the rest)
            flat = res.reshape(-1, res.shape[-1])
            st, assigned, encs = _scan_fit_packed_impl(
                _sq(state), flat, w * (k * m), nv[0], thr, tol,
                k=k, m=m, n_features=n_features,
                criterion=criterion, block=block, max_rounds=max_rounds,
                narrow=narrow, split_k=split_k,
                fanout=fanout,
            )
            return _ex(st), assigned[None], encs[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(None, ax), P(), P(ax), P(), P()),
            out_specs=(P(ax), P(ax), P(ax)),
            check_vma=False,
        )(state, resident, w, n_valid, threshold, tolerance)

    return fit_window_resident


@lru_cache(maxsize=None)
def _retry_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit,
        static_argnames=(
            "m", "n_features", "criterion", "block", "max_rounds",
            "narrow",
        ),
        donate_argnums=(0,),
    )
    def retry(
        state, dev_fps, start, n_valid, missing, threshold, tolerance,
        *, m, n_features, criterion, block, max_rounds, narrow,
    ):
        def body(state, fps, st0, nv, miss, thr, tol):
            rows = _slice_prep_fp_rows_impl(
                fps, st0[0], nv[0], m, n_features
            )
            row_ls, row_n, row_cent, row_pk, row_pop = rows
            row_n = jnp.where(miss[0], row_n, 0)
            st, assigned, _enc = _batch_step_impl(
                _sq(state), row_ls, row_n, row_cent, row_pk, row_pop,
                thr, tol, criterion=criterion, block=block,
                max_rounds=max_rounds, narrow=narrow,
            )
            return _ex(st), assigned[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(ax), P(ax), P(ax), P(ax), P(), P()),
            out_specs=(P(ax), P(ax)),
            check_vma=False,
        )(state, dev_fps, start, n_valid, missing, threshold, tolerance)

    return retry


@lru_cache(maxsize=None)
def _buffer_window_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit,
        static_argnames=(
            "m", "criterion", "block", "max_rounds", "narrow",
            "split_k", "fanout",
        ),
        donate_argnums=(0,),
    )
    def buffer_window(
        state, row_ls, row_n, missing, threshold, tolerance, *, m,
        criterion, block, max_rounds, narrow, split_k, fanout,
    ):
        r"""One batch of pre-aggregated CF rows per device (the
        sharded twin of ``BatchTree.insert_buffers``'s step)."""

        def body(state, ls, n, miss, thr, tol):
            # ls/n shard to (m, F)/(m,) blocks; miss keeps a leading
            # device axis of 1 (it is a (D, m) host mask)
            n_eff = jnp.where(miss[0], n, 0)
            cent = majority_centroid_from_sums(
                ls, jnp.maximum(n_eff, 1)
            )
            row_pk = pack_fingerprints_device(cent)
            row_pop = jnp.sum(cent.astype(jnp.int32), axis=-1)
            st, assigned, enc = _batch_step_impl(
                _sq(state), ls, n_eff, cent.astype(_CENT_DT),
                row_pk, row_pop, thr, tol, criterion=criterion,
                block=block, max_rounds=max_rounds,
                narrow=narrow,
            )
            st, _ = _split_topk_impl(st, k=split_k, fanout=fanout)
            return _ex(st), assigned[None], enc[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(ax), P(ax), P(ax), P(), P()),
            out_specs=(P(ax), P(ax), P(ax)),
            check_vma=False,
        )(state, row_ls, row_n, missing, threshold, tolerance)

    return buffer_window


@lru_cache(maxsize=None)
def _split_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit, static_argnames=("k", "fanout"), donate_argnums=(0,)
    )
    def split(state, *, k, fanout):
        def body(state):
            st, n_left = _split_topk_impl(_sq(state), k=k, fanout=fanout)
            return _ex(st), n_left[None]

        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(ax),),
            out_specs=(P(ax), P(ax)), check_vma=False,
        )(state)

    return split


@lru_cache(maxsize=None)
def _exchange_program_for(mesh: Mesh, ax: str):
    n_dev = int(mesh.devices.size)

    @partial(jax.jit, static_argnames=("stride",))
    def exchange(state, *, stride):
        perm = [
            (s, s - stride)
            for s in range(n_dev)
            if s % (2 * stride) == stride
        ]

        def body(state):
            return _ex(jax.tree.map(
                lambda x: lax.ppermute(x, ax, perm), _sq(state)
            ))

        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(ax),), out_specs=P(ax),
            check_vma=False,
        )(state)

    return exchange


@lru_cache(maxsize=None)
def _merge_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit,
        static_argnames=(
            "m_b", "criterion", "block", "max_rounds",
            "split_k", "fanout",
        ),
        donate_argnums=(0,),
    )
    def merge(
        state, recv, stride, gate, threshold, tolerance, *, m_b,
        criterion, block, max_rounds, split_k, fanout,
    ):
        # stride is TRACED (it only feeds the is_recv predicate, never a
        # shape): the reduction's log2(D) rounds all reuse ONE compiled
        # program — this body is by far the most expensive compile in
        # the package (tens of minutes on a 1-core CPU host), so one
        # program vs log2(D) is the difference between a usable and an
        # unusable cold test suite
        def body(state, recv, strd, gt, thr, tol):
            idx = lax.axis_index(ax)
            is_recv = (idx % (2 * strd)) == 0
            st, amap = _merge_into_impl(
                _sq(state), _sq(recv), is_recv, gt, thr, tol,
                m_b=m_b, criterion=criterion, block=block,
                max_rounds=max_rounds, split_k=split_k, fanout=fanout,
            )
            return _ex(st), amap[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(ax), P(), P(), P(), P()),
            out_specs=(P(ax), P(ax)), check_vma=False,
        )(state, recv, stride, gate, threshold, tolerance)

    return merge


@partial(jax.jit, static_argnames=("chunk", "n_features"))
def _ls_chunk0(state, start, *, chunk, n_features):
    r"""Dense linear sums of device 0's cluster slots (post-merge
    extraction path of :meth:`ShardedForest.linear_sums`)."""
    return _reconstruct_ls_chunk(
        jax.tree.map(lambda x: x[0], state), start, chunk, n_features
    )


@lru_cache(maxsize=None)
def _init_program_for(
    mesh: Mesh, ax: str, d: int, capacity: int, g_capacity: int,
    tile: int, n_features: int, ls_capacity: int,
):
    @partial(jax.jit, out_shardings=NamedSharding(mesh, P(ax)))
    def init():
        base = _init_state(capacity, g_capacity, tile, n_features, ls_capacity)
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (d, *x.shape)), base
        )

    return init


@lru_cache(maxsize=None)
def _grow_program_for(mesh: Mesh, ax: str, new_c: int, new_g: int, new_p: int):
    @partial(jax.jit, out_shardings=NamedSharding(mesh, P(ax)))
    def grow(state):
        # _grow_state knows the per-leaf pad rules (guard values);
        # apply it under vmap over the device axis
        return jax.vmap(
            lambda s: _grow_state(s, new_c, new_g, new_p)
        )(state)

    return grow


@lru_cache(maxsize=None)
def _merge_retry_program_for(mesh: Mesh, ax: str):
    @partial(
        jax.jit,
        static_argnames=(
            "m_b", "criterion", "block", "max_rounds", "split_k",
            "fanout",
        ),
        donate_argnums=(0, 2),
    )
    def merge_retry(
        state, recv, amap, threshold, tolerance, *, m_b, criterion,
        block, max_rounds, split_k, fanout,
    ):
        def body(state, recv, amap, thr, tol):
            st, recv_, amap_ = _sq(state), _sq(recv), _sq(amap)
            # recv keeps its pre-growth capacity after the state grew
            # mid-merge; every mask/map here is recv-sized
            rc = recv_.n.shape[0]
            ciota = lax.broadcasted_iota(jnp.int32, (rc, 1), 0)[:, 0]
            ins = (ciota < recv_.num) & (recv_.n > 0) & (amap_ < 0)
            st, amap_ = _insert_slots_impl(
                st, recv_, ins, amap_, thr, tol, m_b=m_b,
                criterion=criterion, block=block, max_rounds=max_rounds,
                split_k=split_k, fanout=fanout,
            )
            return _ex(st), amap_[None]

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax), P(ax), P(ax), P(), P()),
            out_specs=(P(ax), P(ax)), check_vma=False,
        )(state, recv, amap, threshold, tolerance)

    return merge_retry


class ShardedForest:
    r"""Host driver for the SPMD sharded engine: one batched CF-forest per
    mesh device, merged with collectives after the fit.

    The stacked device state is a ``BatchState`` with a leading device axis
    sharded over the mesh; all fit dispatches are ``shard_map`` programs with
    no collectives, so throughput scales linearly with devices.  The host
    control plane mirrors ``BatchTree``: up to ``pipeline_depth`` windows
    stay in flight with submit-time sync payloads, capacity grows on demand
    (uniform across devices), and rare pending rows retry at boundaries.
    Refinement (``refine_inplace``) and reclustering re-insert surviving
    clusters as sharded CF buffers and re-run the merge reduction.
    """

    def __init__(
        self,
        n_features: int,
        mesh: Mesh,
        *,
        threshold: float = 0.65,
        merge_criterion: str = "diameter",
        tolerance: float = 0.05,
        merge_criterion_merge: str | None = None,
        merge_threshold_change: float = 0.0,
        merge_gate_margin: float = 0.15,
        batch_size: int = 1024,
        scan_batches: int = 16,
        fanout: int | None = None,
        tile: int = 256,
        initial_capacity: int = 8192,
        ls_capacity: int | None = None,
        g_capacity: int | None = None,
        route_block: int = 1024,
        max_rounds: int = 24,
        pipeline_depth: int = 3,
        resident_input_bytes: int = 4 << 30,
        stage_windows: int = 8,
        axis_name: str = "dp",
    ) -> None:
        if fanout is None:
            fanout = min(192, tile * 3 // 4)
        if fanout >= tile:
            raise ValueError("fanout must be < tile (headroom for creations)")
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_devices = int(mesh.devices.size)
        self.threshold = threshold
        self.merge_criterion = merge_criterion
        self.tolerance = tolerance
        self.merge_criterion_merge = (
            merge_criterion_merge
            if merge_criterion_merge is not None
            else merge_criterion
        )
        self.merge_threshold = threshold + merge_threshold_change
        self._merge_threshold_change = merge_threshold_change
        self.merge_gate_margin = merge_gate_margin
        self.batch_size = batch_size
        self.scan_batches = scan_batches
        self.fanout = fanout
        self.tile = tile
        self.route_block = route_block
        self.max_rounds = max_rounds
        # Windows in flight before the oldest boundary settles (the same
        # depth pipelining as BatchTree: popping only the oldest blocks on
        # a window that already finished while newer ones compute)
        self.pipeline_depth = max(1, pipeline_depth)
        # Inputs at most this many bytes (total, sharded across devices)
        # are uploaded ONCE as a window-major resident device buffer and
        # sliced at a traced offset INSIDE the scan program — the same
        # in-program slicing BatchTree uses for device inputs, with no
        # per-window host staging.  Inputs past the budget stream
        # window-by-window with one window of prefetch.  The 4 GiB default
        # holds 16M packed 2048-bit rows: on an 80 GB card a few percent
        # of memory, leaving the rest to the cluster tables.
        self.resident_input_bytes = resident_input_bytes
        # Past the resident budget, inputs stage in chunks of
        # `stage_windows` windows: one bulk device_put per chunk builds a
        # mini window-major resident buffer, sliced at a traced offset
        # in-program (same program family as the resident path), instead
        # of serializing one upload per window against the scan
        # dispatches.
        self.stage_windows = max(1, stage_windows)
        self.split_k = 64

        self.capacity = _next_pow2(
            max(initial_capacity, 2 * batch_size + 1)
        )
        self.ls_capacity = _next_pow2(
            ls_capacity
            if ls_capacity is not None
            else max(min(self.capacity // 4, 1 << 17), 2 * batch_size + 1)
        )
        # Same sizing rule as BatchTree: steady-state group need plus one
        # scan window's split/creation headroom (never a cluster-level
        # worst case — tiles are the dominant HBM term)
        self.g_capacity = _next_pow2(
            g_capacity
            if g_capacity is not None
            # Every group holds at least one slot, so 2*capacity bounds the
            # live groups + in-flight split headroom a capacity-sized table
            # can ever need: without the cap, the worst-case scan headroom
            # (2*k*split_k-ish) forces thousands of group slots — and
            # 268 MB/device of tile tables — onto runs whose slot table
            # holds a few hundred rows (the group table also grows on
            # demand, so the cap costs large runs nothing)
            else max(
                256,
                min(
                    self.capacity * 13 // (10 * max(fanout, 1))
                    + self._scan_g_headroom(),
                    2 * self.capacity,
                ),
            )
        )
        self._sharding = NamedSharding(self.mesh, P(axis_name))
        self.state = self._init_stacked()
        # Host-side per-device upper bounds (uniform capacity => track max)
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        # Window bookkeeping (host): each entry maps window rows back to
        # molecule ids.  kind == "fps": one singleton row per input row,
        # ``mols`` is a (D, rows_per_dev) int64 id array (-1 pads); kind ==
        # "buffers": pre-aggregated CF rows, ``mols`` is a per-device list
        # of per-row mol-id lists (refinement re-inserts surviving clusters
        # this way, mirroring BatchTree.insert_buffers)
        self._windows: list[dict] = []
        self._boundary_queue: list[dict] = []
        self._total_rows = 0
        self._n_mols = 0
        self._merged = False
        self._round_maps: list[tuple[int, dict[int, np.ndarray]]] = []

    # -- device programs -----------------------------------------------------

    def _init_stacked(self) -> BatchState:
        return _init_program_for(
            self.mesh, self.axis_name, self.n_devices, self.capacity,
            self.g_capacity, self.tile, self.n_features, self.ls_capacity,
        )()

    def _grow(self, new_c: int, new_g: int, new_p: int) -> None:
        self.state = _grow_program_for(
            self.mesh, self.axis_name, new_c, new_g, new_p
        )(self.state)
        self.capacity, self.g_capacity, self.ls_capacity = new_c, new_g, new_p

    def _scan_g_headroom(self) -> int:
        r"""Free group slots demanded before a window dispatches (see
        ``BatchTree._scan_g_headroom``)."""
        k, m = self.scan_batches, self.batch_size
        return 2 * k * (self.split_k + 4 * (m // self.tile + 4))

    def _ensure_capacity(
        self,
        incoming: int,
        g_incoming: int | None = None,
        p_incoming: int | None = None,
    ) -> None:
        r"""Grow (uniform across devices) using host upper bounds; exact
        counts are pulled only near the capacity edge.  Group/pool headroom
        is bounded separately (see ``BatchTree._ensure_capacity``) — groups
        carry ``tile * F/8``-byte tiles, so cluster-level worst cases must
        not size the group table; in-table guards pend + retry instead."""
        if g_incoming is None:
            g_incoming = incoming
        if p_incoming is None:
            p_incoming = incoming
        if self._num_upper + incoming + 1 > self.capacity:
            self._num_upper = int(np.asarray(self.state.num).max())
        if self._g_upper + g_incoming + 1 > self.g_capacity:
            self._g_upper = int(np.asarray(self.state.g_num).max())
        if self._ls_upper + p_incoming + 1 > self.ls_capacity:
            self._ls_upper = int(np.asarray(self.state.num_ls).max())
        need_c = self._num_upper + incoming + 1
        need_g = self._g_upper + g_incoming + 1
        need_p = self._ls_upper + p_incoming + 1
        new_c, new_g, new_p = self.capacity, self.g_capacity, self.ls_capacity
        while new_c < need_c:
            new_c *= 2
        while new_g < need_g:
            new_g *= 2
        while new_p < need_p:
            new_p *= 2
        if (new_c, new_g, new_p) != (
            self.capacity, self.g_capacity, self.ls_capacity
        ):
            self._grow(new_c, new_g, new_p)

    @property
    def _fit_window_program(self):
        return _fit_window_program_for(self.mesh, self.axis_name)

    @property
    def _fit_resident_program(self):
        return _fit_resident_program_for(self.mesh, self.axis_name)

    @property
    def _retry_program(self):
        return _retry_program_for(self.mesh, self.axis_name)

    @property
    def _buffer_window_program(self):
        return _buffer_window_program_for(self.mesh, self.axis_name)

    @property
    def _split_program(self):
        return _split_program_for(self.mesh, self.axis_name)

    @property
    def _exchange_program(self):
        return _exchange_program_for(self.mesh, self.axis_name)

    @property
    def _merge_program(self):
        return _merge_program_for(self.mesh, self.axis_name)

    @property
    def _merge_retry_program(self):
        return _merge_retry_program_for(self.mesh, self.axis_name)

    # -- fit -----------------------------------------------------------------

    def warm_programs(self, packed_fps: "np.ndarray | None" = None) -> None:
        r"""Execute this forest's hot programs once with mass-less inputs.

        The sharded twin of ``BatchTree.warm_programs``: runs
        ``max(2, pipeline_depth)`` zero-valid scan windows through this
        forest's OWN state buffers, so a fresh forest pays its per-tree HBM
        allocation + donation churn here instead of inside a timed fit.
        The executables themselves are shared across forests via the
        module-level program cache; what this warms is the buffer chain.
        When ``packed_fps`` is given and fits the resident budget, the
        RESIDENT window program is warmed at the exact ``(n_w, window,
        F8)`` shape the fit will use (jit specializes on the buffer
        shape); otherwise the streamed window program is warmed.  The
        retry program (rare path) is warmed with an all-false missing
        mask.  All calls are mass-less (zero valid rows), so the forest
        state is unchanged.
        """
        m, k, d = self.batch_size, self.scan_batches, self.n_devices
        window = d * k * m
        zero_valids = jax.device_put(np.zeros(d, np.int32), self._sharding)
        thr = jnp.float32(self.threshold)
        tol = jnp.float32(self.tolerance)
        common = dict(
            k=k, m=m, n_features=self.n_features,
            criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds, narrow=m // 4,
            split_k=self.split_k, fanout=self.fanout,
        )
        resident = None
        if packed_fps is not None:
            n_w = -(-len(packed_fps) // window)
            if isinstance(packed_fps, jax.Array) or (
                len(packed_fps) * self.n_bytes <= self.resident_input_bytes
            ):
                # Resident fit: match its window count exactly (jit
                # specializes on the buffer shape; the input pads on
                # device up to a whole number of windows)
                pass
            else:
                # Streamed fit: chunks of `stage_windows` windows run the
                # same resident program family at the chunk shape
                n_w = 1 if n_w <= 1 else self.stage_windows
            if n_w:
                resident = jnp.zeros(
                    (n_w, window, self.n_bytes), jnp.uint8,
                    device=NamedSharding(
                        self.mesh, P(None, self.axis_name)
                    ),
                )
        dev_buf = jnp.zeros(
            (window, self.n_bytes), jnp.uint8, device=self._sharding
        )
        for _ in range(max(2, self.pipeline_depth)):
            if resident is not None:
                self.state, _a, _e = self._fit_resident_program(
                    self.state, resident, jnp.int32(0), zero_valids,
                    thr, tol, **common,
                )
            else:
                self.state, _a, _e = self._fit_window_program(
                    self.state, dev_buf, zero_valids, thr, tol, **common,
                )
        # Rare-path retry program: all-false missing mask => mass-less
        no_miss = jax.device_put(
            np.zeros((d, m), bool), self._sharding
        )
        zeros_i = jax.device_put(np.zeros(d, np.int32), self._sharding)
        self.state, _a = self._retry_program(
            self.state, dev_buf, zeros_i, zero_valids, no_miss, thr, tol,
            m=m, n_features=self.n_features,
            criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds, narrow=m // 4,
        )
        jax.block_until_ready(self.state.n)

    def fit_packed(
        self,
        packed_fps: "np.ndarray",
        mol_indices: "tp.Sequence[int] | np.ndarray | None" = None,
    ) -> None:
        r"""Insert packed fingerprint rows sharded over the mesh.

        Inputs that fit ``resident_input_bytes`` (or arrive as device
        arrays) are uploaded ONCE as a window-major resident buffer and
        sliced at a traced offset INSIDE the scan program (the default;
        see the constructor note).  Otherwise (``packed_fps`` may be a
        memmap) rows stream one ``D * scan_batches * batch_size`` window
        at a time (plus one window of prefetch), so host RSS is bounded by
        the window size, not the input.  Row-to-device assignment and
        batch composition are identical on both paths, so labels are too.
        Rows are assigned to devices in contiguous per-window blocks;
        labels compose at :meth:`merge`.  ``mol_indices`` defaults to
        sequential ids continuing from the rows already inserted
        (refinement passes the exploded rows' original ids).
        """
        if self._merged:
            raise RuntimeError("cannot insert after merge()")
        if len(packed_fps) and packed_fps.shape[-1] != self.n_bytes:
            raise ValueError(
                f"packed rows have {packed_fps.shape[-1]} bytes, expected "
                f"{self.n_bytes} for {self.n_features} features"
            )
        d = self.n_devices
        m, k = self.batch_size, self.scan_batches
        win_d = k * m  # rows per device per window
        window = d * win_d
        num = len(packed_fps)
        if mol_indices is None:
            mol_arr = np.arange(
                self._total_rows, self._total_rows + num, dtype=np.int64
            )
        else:
            mol_arr = np.fromiter(
                mol_indices, dtype=np.int64, count=num
            ) if not isinstance(mol_indices, np.ndarray) else np.asarray(
                mol_indices, dtype=np.int64
            )
            if len(mol_arr) != num:
                raise ValueError(
                    f"mol_indices has {len(mol_arr)} entries for {num} "
                    "packed rows — ids would misalign with their rows"
                )
        if num:
            self._n_mols = max(self._n_mols, int(mol_arr.max()) + 1)

        resident = None
        n_res = 0  # windows covered by the resident buffer
        if num and (
            isinstance(packed_fps, jax.Array)
            or num * self.n_bytes <= self.resident_input_bytes
        ):
            if not isinstance(packed_fps, jax.Array):
                # Host input within the resident budget: stage the RAW
                # array whole with a plain device_put — the queue is empty
                # at fit start, so this rides the bulk-copy path (a
                # host-side pad or per-shard staging copy would cost host
                # time) — then fall through to the device-input path so
                # BOTH input kinds run ONE compiled variant.
                packed_fps = jax.device_put(np.asarray(packed_fps))
                jax.block_until_ready(packed_fps)
            # Pad on DEVICE (one cheap HBM copy) so every window —
            # including a partial tail — slices the resident buffer
            n_res = -(-num // window)
            pad = n_res * window - num
            buf = (
                jnp.pad(packed_fps, ((0, pad), (0, 0)))
                if pad
                else packed_fps
            )
            # Window-major layout: resident[w] is one window's rows,
            # sharded over devices in the same contiguous per-device
            # blocks the streamed path uploads (labels are identical);
            # the reshard is device-to-device (free on one device,
            # NVLink between cards)
            resident = jax.device_put(
                buf.reshape(n_res, window, self.n_bytes),
                NamedSharding(self.mesh, P(None, self.axis_name)),
            )

        def meta(start: int):
            stop = min(start + window, num)
            mols = mol_arr[start:stop]
            if stop - start < window:
                mols = np.pad(
                    mols, (0, window - (stop - start)), constant_values=-1
                )
            valids = np.clip(
                (stop - start) - win_d * np.arange(d), 0, win_d
            ).astype(np.int32)
            return valids, mols.reshape(d, win_d)

        if resident is not None:
            for wi, start in enumerate(range(0, num, window)):
                valids, mols = meta(start)
                self._submit_window(
                    None, valids, mols, resident=resident, w=wi
                )
        elif num:
            # Chunked streamed staging: each chunk is a mini window-major
            # resident buffer of `stage_windows` windows, uploaded with ONE
            # bulk device_put and sliced at a traced offset in-program
            # (same program family as the resident path, keyed on the
            # chunk's window count).  Only the final partial chunk pays a
            # host pad copy; full chunks transfer straight from the input
            # (which may be a memmap — host RSS stays bounded by the chunk).
            # Exactly two chunk shapes (jit specializes on the buffer):
            # single-window inputs keep the one-window buffer, larger
            # inputs use the full stage_windows chunk (a short final chunk
            # transfers some zero padding — far cheaper than a per-size
            # program compile)
            n_windows = -(-num // window)
            cw = 1 if n_windows <= 1 else self.stage_windows
            chunk_rows = cw * window

            def upload_chunk(cstart: int):
                stop = min(cstart + chunk_rows, num)
                if stop <= cstart:
                    return None
                chunk = np.asarray(packed_fps[cstart:stop])
                if stop - cstart < chunk_rows:
                    chunk = np.pad(
                        chunk, ((0, chunk_rows - (stop - cstart)), (0, 0))
                    )
                return jax.device_put(
                    np.ascontiguousarray(chunk).reshape(
                        cw, window, self.n_bytes
                    ),
                    NamedSharding(self.mesh, P(None, self.axis_name)),
                )

            cur = upload_chunk(0)
            nxt = None
            for wi, start in enumerate(range(0, num, window)):
                coff = wi % cw
                if wi and coff == 0:
                    cur = nxt if nxt is not None else upload_chunk(start)
                    nxt = None
                valids, mols = meta(start)
                self._submit_window(
                    None, valids, mols, resident=cur, w=coff
                )
                if nxt is None:
                    # Prefetch the next chunk right after the current
                    # chunk's first window dispatches: the transfer
                    # overlaps the in-flight windows' compute
                    nxt = upload_chunk((wi // cw + 1) * chunk_rows)
        self._total_rows += num
        self.flush()

    def _submit_window(
        self,
        dev_buf: "Array | None",
        valids: np.ndarray,
        mols: np.ndarray,
        *,
        resident: "Array | None" = None,
        w: int = -1,
    ) -> None:
        m, k = self.batch_size, self.scan_batches
        # p_incoming=0: pool allocations are guarded in-step (see
        # BatchTree._submit_scan)
        self._ensure_capacity(
            k * m, g_incoming=self._scan_g_headroom(), p_incoming=0
        )
        if resident is not None:
            self.state, assigned, encs = self._fit_resident_program(
                self.state, resident, jnp.int32(w),
                jax.device_put(valids, self._sharding),
                jnp.float32(self.threshold), jnp.float32(self.tolerance),
                k=k, m=m, n_features=self.n_features,
                criterion=self.merge_criterion, block=self.route_block,
                max_rounds=self.max_rounds, narrow=m // 4,
                split_k=self.split_k, fanout=self.fanout,
            )
        else:
            self.state, assigned, encs = self._fit_window_program(
                self.state, dev_buf,
                jax.device_put(valids, self._sharding),
                jnp.float32(self.threshold), jnp.float32(self.tolerance),
                k=k, m=m, n_features=self.n_features,
                criterion=self.merge_criterion, block=self.route_block,
                max_rounds=self.max_rounds, narrow=m // 4,
                split_k=self.split_k, fanout=self.fanout,
            )
        n_valid = int(valids.max(initial=0))
        self._num_upper += n_valid
        # _ls_upper intentionally not advanced: the in-step pool guard
        # makes over-allocation impossible and flush() refreshes the bound
        self._g_upper += k * self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._windows.append(
            {
                "kind": "fps",
                "assigned": assigned.reshape(self.n_devices, -1),
                "valids": valids,
                "mols": mols,
            }
        )
        self._boundary_queue.append(
            {
                "kind": "fps",
                "win_idx": len(self._windows) - 1,
                # Resident windows carry (resident, w) instead of a window
                # buffer; the rare retry path materializes the slice lazily
                "dev_fps": dev_buf,
                "resident": resident,
                "w": w,
                "valids": valids,
                "enc_cols": k,
                # Submit-time sync payload: pulling it at the boundary
                # blocks only on THIS window's program (see
                # BatchTree._submit_scan); the true per-device counters
                # piggyback on the same fetch
                "sync": jnp.concatenate(
                    [
                        encs,
                        jnp.stack(
                            [
                                self.state.num,
                                self.state.g_num,
                                self.state.num_ls,
                            ],
                            axis=1,
                        ),
                    ],
                    axis=1,
                ),
            }
        )
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def insert_buffers(
        self,
        buffers: np.ndarray,
        mol_index_seqs: tp.Sequence[tp.Sequence[int]],
    ) -> None:
        r"""Insert pre-aggregated CF buffers ``[linear_sum..., n]`` sharded
        over the mesh (contiguous per-device blocks, one batch-step +
        split pass per device per window) — the sharded twin of
        ``BatchTree.insert_buffers``; refinement re-inserts surviving
        clusters through this path."""
        if self._merged:
            raise RuntimeError("cannot insert after merge()")
        d, m = self.n_devices, self.batch_size
        window = d * m
        buffers = np.asarray(buffers)
        ls = buffers[:, :-1].astype(np.int32)
        ns = buffers[:, -1].astype(np.int32)
        mols = [list(s) for s in mol_index_seqs]
        if mols:
            self._n_mols = max(
                self._n_mols,
                max((max(s, default=-1) for s in mols), default=-1) + 1,
            )
        num = len(ls)
        for start in range(0, num, window):
            stop = min(start + window, num)
            chunk_ls = ls[start:stop]
            chunk_n = ns[start:stop]
            pad = window - (stop - start)
            if pad:
                chunk_ls = np.pad(chunk_ls, ((0, pad), (0, 0)))
                chunk_n = np.pad(chunk_n, (0, pad))
            valids = np.clip(
                (stop - start) - m * np.arange(d), 0, m
            ).astype(np.int32)
            mol_chunk = mols[start:stop] + [[] for _ in range(pad)]
            self._submit_buffer_window(
                jax.device_put(
                    np.ascontiguousarray(chunk_ls), self._sharding
                ),
                jax.device_put(
                    np.ascontiguousarray(chunk_n), self._sharding
                ),
                valids,
                [mol_chunk[dev * m : (dev + 1) * m] for dev in range(d)],
            )
        self.flush()

    def _submit_buffer_window(
        self,
        dev_ls: Array,
        dev_n: Array,
        valids: np.ndarray,
        mols: list[list[list[int]]],
    ) -> None:
        d, m = self.n_devices, self.batch_size
        n_valid = int(valids.max(initial=0))
        # CF rows can all demand pool rows (multi-member clusters), so the
        # pool headroom is bounded up-front here, unlike the fps path
        self._ensure_capacity(
            m, g_incoming=self.split_k + 4 * (m // self.tile + 4),
            p_incoming=m,
        )
        missing = jax.device_put(
            np.arange(m)[None, :] < valids[:, None], self._sharding
        )
        self.state, assigned, enc = self._buffer_window_program(
            self.state, dev_ls, dev_n, missing,
            jnp.float32(self.threshold), jnp.float32(self.tolerance),
            m=m, criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds, narrow=m // 4,
            split_k=self.split_k, fanout=self.fanout,
        )
        self._num_upper += n_valid
        self._ls_upper += n_valid
        self._g_upper += self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._windows.append(
            {
                "kind": "buffers",
                "assigned": assigned.reshape(d, m),
                "valids": valids,
                "mols": mols,
            }
        )
        self._boundary_queue.append(
            {
                "kind": "buffers",
                "win_idx": len(self._windows) - 1,
                "dev_ls": dev_ls,
                "dev_n": dev_n,
                "valids": valids,
                "enc_cols": 1,
                "sync": jnp.concatenate(
                    [
                        enc[:, None],
                        jnp.stack(
                            [
                                self.state.num,
                                self.state.g_num,
                                self.state.num_ls,
                            ],
                            axis=1,
                        ),
                    ],
                    axis=1,
                ),
            }
        )
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def flush(self) -> None:
        r"""Drain every deferred boundary, then a split pass."""
        while self._boundary_queue:
            self._process_oldest_boundary()
        self._split_drain(drain=False)

    def _process_oldest_boundary(self) -> None:
        r"""Pop and settle the OLDEST deferred boundary (see
        ``BatchTree._process_oldest_boundary``): the pull reads the entry's
        submit-time sync payload, so it blocks only on that window's
        program while newer windows keep the devices busy."""
        q = self._boundary_queue.pop(0)
        k = self.scan_batches
        flat = np.asarray(q["sync"])  # (D, enc_cols + 3); blocks on q only
        pending = flat[:, : q["enc_cols"]] // 1000
        # True per-device counters as of this window, plus the worst-case
        # contributions of the newer windows still in flight
        extra_rows = extra_g = 0
        for q2 in self._boundary_queue:
            nv2 = int(q2["valids"].max(initial=0))
            extra_rows += nv2
            extra_g += (k if q2["kind"] == "fps" else 1) * self.split_k + max(
                16, 4 * (nv2 // self.tile + 1)
            )
        self._num_upper = int(flat[:, -3].max()) + extra_rows
        self._g_upper = int(flat[:, -2].max()) + extra_g
        # fps windows are not charged per-row against the pool (the
        # in-step guard pends on exhaustion — see the BatchTree twin);
        # buffer windows CAN all take pool rows, so they charge fully
        extra_pool = sum(
            int(q2["valids"].max(initial=0))
            if q2["kind"] == "buffers"
            else 2 * self.batch_size
            for q2 in self._boundary_queue
        )
        self._ls_upper = int(flat[:, -1].max()) + extra_pool
        # Proactive pool headroom while the counters are fresh (sync-free)
        self._ensure_capacity(
            0, g_incoming=0, p_incoming=2 * self.batch_size
        )
        if (pending > 0).any():
            if q["kind"] == "fps":
                self._retry_window(q, pending)
            else:
                self._retry_buffer_window(q)
            self._split_drain(drain=False)

    def _split_drain(self, drain: bool) -> None:
        k = self.split_k
        for _ in range(64):
            self._ensure_capacity(k)
            self.state, n_left = self._split_program(
                self.state, k=k, fanout=self.fanout
            )
            self._g_upper += k
            if not drain or int(np.asarray(n_left).max()) <= 0:
                return

    def _retry_window(self, q: dict, pending: np.ndarray) -> None:
        r"""Drain a window whose scan left pending rows on some device
        (rare): split fully, then masked re-steps per affected batch."""
        d = self.n_devices
        m, k = self.batch_size, self.scan_batches
        win = self._windows[q["win_idx"]]
        assigned_dev, valids = win["assigned"], win["valids"]
        dev_fps = q["dev_fps"]
        if dev_fps is None:  # resident window: materialize the slice now
            dev_fps = _slice_window(q["resident"], jnp.int32(q["w"]))
        final = np.array(np.asarray(assigned_dev))  # (D, k*m)
        valid_rows = (
            np.arange(k * m)[None, :] < valids[:, None]
        )  # (D, k*m)
        for i in range(k):
            if not (pending[:, i] > 0).any():
                continue
            seg = slice(i * m, (i + 1) * m)
            for _attempt in range(64):
                missing = (final[:, seg] == -1) & valid_rows[:, seg]
                if not missing.any():
                    break
                self._split_drain(drain=True)
                self._ensure_capacity(m)
                starts = np.full(d, i * m, np.int32)
                nv = np.clip(valids - i * m, 0, m).astype(np.int32)
                self.state, assigned = self._retry_program(
                    self.state, dev_fps,
                    jax.device_put(starts, self._sharding),
                    jax.device_put(nv, self._sharding),
                    jax.device_put(missing, self._sharding),
                    jnp.float32(self.threshold),
                    jnp.float32(self.tolerance),
                    m=m, n_features=self.n_features,
                    criterion=self.merge_criterion,
                    block=self.route_block, max_rounds=self.max_rounds,
                    narrow=m // 4,
                )
                n_miss = int(missing.sum(1).max(initial=0))
                self._num_upper += n_miss
                self._g_upper += n_miss
                self._ls_upper += n_miss
                assigned_np = np.asarray(assigned)
                final[:, seg][missing] = assigned_np[missing]
            else:
                raise RuntimeError("sharded engine failed to drain a window")
        win["assigned"] = final

    def _retry_buffer_window(self, q: dict) -> None:
        r"""Drain a buffer window whose step left pending CF rows on some
        device (rare): split fully, then masked re-steps until placed."""
        m = self.batch_size
        win = self._windows[q["win_idx"]]
        final = np.array(np.asarray(win["assigned"]))  # (D, m)
        valids = win["valids"]
        valid_rows = np.arange(m)[None, :] < valids[:, None]
        for _attempt in range(64):
            missing = (final == -1) & valid_rows
            if not missing.any():
                break
            self._split_drain(drain=True)
            self._ensure_capacity(m, p_incoming=m)
            self.state, assigned, _enc = self._buffer_window_program(
                self.state, q["dev_ls"], q["dev_n"],
                jax.device_put(missing, self._sharding),
                jnp.float32(self.threshold), jnp.float32(self.tolerance),
                m=m, criterion=self.merge_criterion,
                block=self.route_block, max_rounds=self.max_rounds,
                narrow=m // 4, split_k=self.split_k, fanout=self.fanout,
            )
            n_miss = int(missing.sum(1).max(initial=0))
            self._num_upper += n_miss
            self._g_upper += n_miss + self.split_k
            self._ls_upper += n_miss
            assigned_np = np.asarray(assigned).reshape(final.shape)
            final[missing] = assigned_np[missing]
        else:
            raise RuntimeError(
                "sharded engine failed to drain a buffer window"
            )
        win["assigned"] = final

    # -- merge ---------------------------------------------------------------

    def merge(self) -> None:
        r"""Run the ``ceil(log2(D))`` reduction rounds; device 0 ends up
        holding the global forest.  Idempotent."""
        if self._merged:
            return
        self.flush()
        self._split_drain(drain=True)
        d = self.n_devices
        if d > 1:
            gate = np.clip(
                self.merge_threshold - self.merge_gate_margin, 0.0, 1.0
            )
            m_b = self.batch_size
            num_rounds = math.ceil(math.log2(d))
            for r in range(num_rounds):
                stride = 1 << r
                receivers = [
                    s - stride
                    for s in range(d)
                    if s % (2 * stride) == stride
                ]
                # Uniform capacity: the worst pair must fit own + received
                nums = np.asarray(self.state.num)
                gnums = np.asarray(self.state.g_num)
                pnums = np.asarray(self.state.num_ls)
                need_c = need_g = need_p = 0
                for recv_d in receivers:
                    s = recv_d + stride
                    need_c = max(need_c, int(nums[recv_d] + nums[s]))
                    need_g = max(
                        need_g,
                        int(
                            gnums[recv_d] + gnums[s]
                            + nums[s] // self.tile + self.split_k + 16
                        ),
                    )
                    need_p = max(
                        need_p, int(pnums[recv_d] + pnums[s] + nums[s])
                    )
                self._num_upper = need_c
                self._g_upper = need_g
                self._ls_upper = need_p
                self._ensure_capacity(m_b + 1)
                recv = self._exchange_program(self.state, stride=stride)
                self.state, amap = self._merge_program(
                    self.state, recv, jnp.int32(stride), jnp.float32(gate),
                    jnp.float32(self.merge_threshold),
                    jnp.float32(self.tolerance), m_b=m_b,
                    criterion=self.merge_criterion_merge,
                    block=self.route_block, max_rounds=self.max_rounds,
                    split_k=self.split_k, fanout=self.fanout,
                )
                # Retry until every live received slot is mapped (capacity
                # growth is the usual reason a slot pends)
                for _attempt in range(64):
                    amap_np = np.asarray(amap)  # (D, C_cap)
                    missing = False
                    for recv_d in receivers:
                        s = recv_d + stride
                        n_recv = int(nums[s])
                        if (amap_np[recv_d, :n_recv] < 0).any():
                            missing = True
                    if not missing:
                        break
                    # Sync true counts: overflow-chunk creations during the
                    # insert loop can outrun the host's loose upper bounds,
                    # and a stale bound here would skip the growth the
                    # pending rows are waiting for
                    self._num_upper = int(np.asarray(self.state.num).max())
                    self._g_upper = int(np.asarray(self.state.g_num).max())
                    self._ls_upper = int(np.asarray(self.state.num_ls).max())
                    self._ensure_capacity(2 * m_b)
                    self.state, amap = self._merge_retry_program(
                        self.state, recv, amap,
                        jnp.float32(self.merge_threshold),
                        jnp.float32(self.tolerance), m_b=m_b,
                        criterion=self.merge_criterion_merge,
                        block=self.route_block,
                        max_rounds=self.max_rounds,
                        split_k=self.split_k, fanout=self.fanout,
                    )
                else:
                    raise RuntimeError(
                        "sharded merge failed to place every received row"
                    )
                del recv
                self._round_maps.append(
                    (
                        stride,
                        {recv_d: amap_np[recv_d] for recv_d in receivers},
                    )
                )
        self._merged = True

    # -- extraction ----------------------------------------------------------

    def labels(self) -> np.ndarray:
        r"""Final cluster slot per molecule id (composed on host).

        The output is indexed by MOLECULE id: sequential fits produce one
        row per input row in order; after :meth:`refine_inplace` the ids
        still address the original input rows (surviving clusters carry
        their member ids through the CF-buffer windows).
        """
        self.merge()
        d = self.n_devices
        parts: list[np.ndarray] = []
        dev_parts: list[np.ndarray] = []
        spans: list[tuple[dict, int, int, int]] = []  # (win, dev, a, b)
        pos = 0
        for win in self._windows:
            arr = np.asarray(win["assigned"])
            for dev in range(d):
                nv = int(win["valids"][dev])
                if nv:
                    parts.append(arr[dev, :nv])
                    dev_parts.append(np.full(nv, dev, np.int64))
                    spans.append((win, dev, pos, pos + nv))
                    pos += nv
        if not parts:
            return np.empty(0, np.int64)
        slots = np.concatenate(parts).astype(np.int64)
        dev_of = np.concatenate(dev_parts)
        for stride, maps in self._round_maps:
            for recv_d, amap in maps.items():
                sent = dev_of == recv_d + stride
                if sent.any():
                    slots[sent] = amap[slots[sent]]
                    dev_of[sent] = recv_d
        # Scatter window rows back to molecule ids
        out = np.full(self._n_mols, -1, np.int64)
        for win, dev, a, b in spans:
            if win["kind"] == "fps":
                mols = win["mols"][dev, : b - a]
                out[mols] = slots[a:b]
            else:
                row_slots = slots[a:b]
                for i, seq in enumerate(win["mols"][dev][: b - a]):
                    if seq:
                        out[np.asarray(seq, dtype=np.int64)] = row_slots[i]
        return out

    def cluster_mols(self) -> list[list[int]]:
        r"""Molecule ids per merged cluster slot (host-side)."""
        labels = self.labels()
        ncl = self.num_clusters
        present = labels >= 0
        order = np.argsort(labels[present], kind="stable")
        mol_ids = np.flatnonzero(present)[order]
        bounds = np.searchsorted(
            labels[present][order], np.arange(ncl + 1)
        )
        return [
            mol_ids[bounds[i] : bounds[i + 1]].tolist() for i in range(ncl)
        ]

    # -- refinement ------------------------------------------------------

    def reset(
        self,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
        merge_threshold_change: float | None = None,
    ) -> None:
        r"""Clear the forest (all devices), optionally re-parameterized.
        Molecule-id space is preserved so refinement labels stay addressed
        by the original input rows.

        ``merge_threshold_change`` replaces the stored fit->merge threshold
        delta.  Refinement passes 0.0 together with an already-shifted
        ``threshold`` so the reduction rounds run at the SAME refined
        threshold as the fit (the reference applies ``set_merge(refine,
        thresh + change)`` uniformly, ``bblean/cli.py``); without it the
        stored delta would be applied on top of the shifted threshold —
        twice in total."""
        self.flush()
        if merge_threshold_change is not None:
            self._merge_threshold_change = merge_threshold_change
        if threshold is not None:
            self.threshold = threshold
        if threshold is not None or merge_threshold_change is not None:
            self.merge_threshold = (
                self.threshold + self._merge_threshold_change
            )
        if merge_criterion is not None:
            self.merge_criterion = merge_criterion
            self.merge_criterion_merge = merge_criterion
        if tolerance is not None:
            self.tolerance = tolerance
        self.state = self._init_stacked()
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        self._windows = []
        self._boundary_queue = []
        self._round_maps = []
        self._merged = False

    def refine_inplace(
        self,
        X: "np.ndarray | tp.Any",
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
        merge_threshold_change: float | None = None,
    ) -> "ShardedForest":
        r"""Explode the ``n_largest`` merged clusters into singletons and
        re-fit over the mesh.

        Mirrors ``BatchTree.refine_inplace`` (reference flow
        ``bblean/bitbirch.py:1187-1214`` + the in-worker refinement of
        ``bblean/multiround.py:196-214``): surviving clusters re-insert as
        sharded CF buffers largest-first, then the exploded rows re-insert
        as sharded singletons (their original fingerprints reloaded from
        ``X`` by molecule id), and the reduction rounds re-merge.
        """
        if n_largest < 0:
            raise ValueError("n_largest must be >= 0")
        self.merge()
        sizes = self.cluster_sizes()
        ls = self.linear_sums()
        mols = self.cluster_mols()
        order = np.argsort(-sizes, kind="stable")
        big, rest = order[:n_largest], order[n_largest:]

        exploded_mols = [m for i in big for m in mols[i]]
        from bblean_tpu.engine.batch import _load_rows_by_mol

        rows, row_mols = _load_rows_by_mol(
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
            merge_threshold_change=merge_threshold_change,
        )
        if len(buffers):
            self.insert_buffers(buffers, buffer_mols)
        if len(rows):
            self.fit_packed(rows, np.asarray(row_mols, dtype=np.int64))
        self.merge()
        return self

    def recluster_inplace(
        self,
        iterations: int = 1,
        extra_threshold: float = 0.0,
        shuffle: bool = False,
        seed: int | None = None,
    ) -> "ShardedForest":
        r"""Re-insert every merged cluster as a sharded CF buffer,
        optionally shuffled, bumping the threshold per iteration (the
        sharded twin of ``BatchTree.recluster_inplace``)."""
        rng = np.random.default_rng(seed)
        for _ in range(iterations):
            self.merge()
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
            self.merge()
        return self

    @property
    def num_clusters(self) -> int:
        self.merge()
        return int(np.asarray(self.state.num)[0])

    def cluster_sizes(self) -> np.ndarray:
        self.merge()
        return np.asarray(self.state.n)[0][: self.num_clusters]

    def linear_sums(self) -> np.ndarray:
        r"""(C, F) int32 linear sums of the merged forest (device 0),
        reconstructed from the sparse pool in device chunks."""
        self.merge()
        ncl = self.num_clusters
        out = np.empty((ncl, self.n_features), np.int32)
        chunk = 1 << 15
        for start in range(0, ncl, chunk):
            size = min(chunk, ncl - start)
            rows = _ls_chunk0(
                self.state, jnp.int32(start), chunk=chunk,
                n_features=self.n_features,
            )
            out[start : start + size] = np.asarray(rows)[:size]
        return out

    def state_bytes_per_device(self) -> int:
        r"""Device-table footprint per device (capacity-sized)."""
        return sum(
            int(np.prod(x.shape[1:])) * x.dtype.itemsize
            for x in self.state
        )


def sharded_fit(
    fps: np.ndarray,
    mesh: Mesh,
    *,
    input_is_packed: bool = False,
    n_features: int | None = None,
    threshold: float = 0.65,
    merge_criterion: str = "diameter",
    tolerance: float = 0.05,
    merge_criterion_merge: str | None = None,
    merge_threshold_change: float = 0.0,
    merge_gate_margin: float = 0.15,
    batch_size: int = 256,
    scan_batches: int = 16,
    capacity: int | None = None,
    g_capacity: int | None = None,
    fanout: int | None = None,
    tile: int = 256,
    centroid_block: int = 512,
    max_rounds: int = 24,
    axis_name: str = "dp",
) -> ShardedClusters:
    r"""Cluster fingerprints data-parallel over a device mesh.

    ``fps`` may be unpacked 0/1 rows or packed bytes (``input_is_packed``),
    including a memmap — rows stream through in windows.  Capacity defaults
    grow on demand from the clusters each device discovers (decoupled from
    the input size).
    """
    if input_is_packed:
        if n_features is None:
            n_features = fps.shape[1] * 8
        packed = np.asarray(fps, dtype=np.uint8)
    else:
        n_features = fps.shape[1]
        packed = np.packbits(np.asarray(fps, dtype=np.uint8), axis=-1)

    # Spread small inputs over the whole mesh: shrink the scan window so one
    # window's per-device block does not swallow every row on device 0
    d = int(mesh.devices.size)
    scan_batches = max(
        1, min(scan_batches, -(-len(packed) // (d * batch_size)))
    )

    forest = ShardedForest(
        n_features,
        mesh,
        threshold=threshold,
        merge_criterion=merge_criterion,
        tolerance=tolerance,
        merge_criterion_merge=merge_criterion_merge,
        merge_threshold_change=merge_threshold_change,
        merge_gate_margin=merge_gate_margin,
        batch_size=batch_size,
        scan_batches=scan_batches,
        fanout=fanout,
        tile=tile,
        initial_capacity=(
            capacity if capacity is not None else 2 * batch_size + 2
        ),
        g_capacity=g_capacity,
        route_block=centroid_block,
        max_rounds=max_rounds,
        axis_name=axis_name,
    )
    forest.fit_packed(packed)
    forest.merge()
    labels = forest.labels()
    sizes = forest.cluster_sizes()
    return ShardedClusters(
        labels=labels,
        linear_sums=forest.linear_sums(),
        sizes=sizes,
        num_clusters=forest.num_clusters,
    )
