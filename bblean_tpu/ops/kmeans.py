r"""Device k-means over cluster centroids (global clustering).

The reference's experimental ``global_clustering`` hands leaf centroids to
sklearn's host KMeans (``bblean/bitbirch.py:1355-1425``).  This is the
device equivalent: k-means++ seeding and Lloyd iterations as jitted XLA
programs — every distance pass is one matmul, the center update one
segment-sum — so re-clustering 100k+ centroids stays on device.

Works on any backend (tests run it on CPU); selected through
``BitBirch.global_clustering(method="kmeans-jax")``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

__all__ = ["kmeans_fit_predict"]


def _sq_dists(x: Array, c: Array, x_sq: Array) -> Array:
    r"""Squared euclidean distances (N, K) via one matmul (full f32
    precision: a TF32 product would move points across Voronoi borders)."""
    prod = lax.dot_general(
        x, c, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    c_sq = jnp.sum(c * c, axis=-1)
    return jnp.maximum(x_sq[:, None] - 2.0 * prod + c_sq[None, :], 0.0)


@functools.partial(jax.jit, static_argnames=("n_clusters", "n_iters"))
def _kmeans_impl(
    x: Array,  # (N, D) f32
    key: Array,
    *,
    n_clusters: int,
    n_iters: int,
) -> tuple[Array, Array]:
    n, d = x.shape
    x_sq = jnp.sum(x * x, axis=-1)

    # ---- k-means++ seeding: each next center drawn with prob ∝ D(x)^2 ----
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers0 = jnp.zeros((n_clusters, d), jnp.float32).at[0].set(x[first])
    min_d0 = jnp.sum((x - x[first][None, :]) ** 2, axis=-1)

    def seed_step(carry, i):
        centers, min_d, key = carry
        key, sub = jax.random.split(key)
        # Gumbel-max categorical over log(min_d): robust when mass collapses
        logits = jnp.log(jnp.maximum(min_d, 1e-30))
        pick = jnp.argmax(
            logits + jax.random.gumbel(sub, (n,), jnp.float32)
        )
        c = x[pick]
        centers = centers.at[i].set(c)
        min_d = jnp.minimum(min_d, jnp.sum((x - c[None, :]) ** 2, axis=-1))
        return (centers, min_d, key), None

    (centers, _, key), _ = lax.scan(
        seed_step,
        (centers0, min_d0, key),
        jnp.arange(1, n_clusters),
    )

    # ---- Lloyd iterations ----
    def lloyd(_, centers):
        labels = jnp.argmin(_sq_dists(x, centers, x_sq), axis=-1)
        sums = jax.ops.segment_sum(x, labels, num_segments=n_clusters)
        counts = jax.ops.segment_sum(
            jnp.ones((n,), jnp.float32), labels, num_segments=n_clusters
        )
        # Empty clusters keep their previous center
        new = jnp.where(
            (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None],
            centers,
        )
        return new

    centers = lax.fori_loop(0, n_iters, lloyd, centers)
    labels = jnp.argmin(_sq_dists(x, centers, x_sq), axis=-1)
    return labels.astype(jnp.int32), centers


def kmeans_fit_predict(
    points: np.ndarray,
    n_clusters: int,
    *,
    n_iters: int = 50,
    seed: int = 0,
) -> np.ndarray:
    r"""Cluster ``points`` into ``n_clusters``; returns 0-based labels.

    k-means++ seeding + ``n_iters`` Lloyd steps, entirely on device.
    """
    x = jnp.asarray(np.asarray(points, dtype=np.float32))
    if n_clusters < 1:
        raise ValueError("n_clusters must be >= 1")
    if n_clusters == 1:
        return np.zeros(len(points), dtype=np.int64)
    if n_clusters > len(points):
        raise ValueError("n_clusters exceeds the number of points")
    labels, _ = _kmeans_impl(
        x, jax.random.PRNGKey(seed), n_clusters=n_clusters, n_iters=n_iters
    )
    return np.asarray(labels).astype(np.int64)
