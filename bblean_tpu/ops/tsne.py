r"""JAX-native t-SNE for cluster visualization.

The reference uses openTSNE with FFT gradients for very large point sets
(``bblean/plotting.py:297-394``).  This framework's plotting path embeds the
*top clusters'* fingerprints (thousands of points, not millions), where the
exact O(N^2) gradient is small enough to run entirely on the accelerator:
pairwise distances and the attraction/repulsion terms are matmuls, the
per-point perplexity calibration is a vectorized bisection, and the descent
loop is one ``lax.fori_loop`` — no host round-trips after the upload.

Feature parity with the reference surface: perplexity, seed, PCA init,
second-phase exaggeration, multiscale affinities (perplexity mixture), and
the t-distribution ``dof`` knob.  openTSNE, when installed, is still
preferred by the plotting layer for bit-compatible outputs.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["tsne_embed"]


def _pairwise_sq_dists(x):
    import jax.numpy as jnp
    from jax import lax

    sq = jnp.sum(x * x, axis=1)
    # Full f32 products: a TF32 matmul (the GPU default) keeps ~3 digits,
    # which distorts the small distances the affinities are built from
    gram = jnp.matmul(x, x.T, precision=lax.Precision.HIGHEST)
    d2 = sq[:, None] - 2.0 * gram + sq[None, :]
    return jnp.maximum(d2, 0.0)


def _calibrate_rows(d2, perplexity: float, iters: int = 50):
    r"""Per-row conditional affinities P(j|i) at the target perplexity via
    vectorized bisection over the precision beta."""
    import jax.numpy as jnp
    from jax import lax

    n = d2.shape[0]
    target = jnp.log(jnp.float32(perplexity))
    eye = jnp.eye(n, dtype=bool)

    def entropy_and_p(beta):
        w = jnp.exp(-d2 * beta[:, None])
        w = jnp.where(eye, 0.0, w)
        sum_w = jnp.maximum(jnp.sum(w, axis=1), 1e-12)
        p = w / sum_w[:, None]
        # Shannon entropy H = log(sum_w) + beta * <d2>_p
        h = jnp.log(sum_w) + beta * jnp.sum(d2 * p, axis=1) / sum_w * sum_w
        h = jnp.log(sum_w) + beta * jnp.sum(d2 * p, axis=1)
        return h, p

    def body(_, carry):
        beta, lo, hi = carry
        h, _ = entropy_and_p(beta)
        too_high = h > target  # entropy too high -> raise beta
        lo = jnp.where(too_high, beta, lo)
        hi = jnp.where(too_high, hi, beta)
        beta = jnp.where(
            jnp.isinf(hi), beta * 2.0, (lo + hi) * 0.5
        )
        return beta, lo, hi

    beta0 = jnp.ones((n,), jnp.float32)
    lo0 = jnp.zeros((n,), jnp.float32)
    hi0 = jnp.full((n,), jnp.inf, jnp.float32)
    beta, _, _ = lax.fori_loop(0, iters, body, (beta0, lo0, hi0))
    _, p = entropy_and_p(beta)
    return p


@functools.partial(
    lambda f: f,
)
def _descend(p, y0, n_iter: int, exaggeration: float, early_exag: float,
             early_iter: int, learning_rate: float, dof: float):
    import jax.numpy as jnp
    from jax import lax

    n = y0.shape[0]
    eye = jnp.eye(n, dtype=bool)
    a = (dof + 1.0) / 2.0

    def grad(y, exag):
        d2 = _pairwise_sq_dists(y)
        w = (1.0 + d2 / dof) ** (-a)  # student-t kernel
        w = jnp.where(eye, 0.0, w)
        z = jnp.maximum(jnp.sum(w), 1e-12)
        q = w / z
        mult = (exag * p - q) * w ** (1.0 / a)  # (P-Q) * (1+d2/dof)^-1
        # dC/dy_i = 4 * sum_j mult_ij (y_i - y_j)
        row = jnp.sum(mult, axis=1)
        return 4.0 * (
            row[:, None] * y
            - jnp.matmul(mult, y, precision=lax.Precision.HIGHEST)
        )

    def body(i, carry):
        y, vel, gains = carry
        exag = jnp.where(i < early_iter, early_exag, exaggeration)
        g = grad(y, exag)
        same_sign = jnp.sign(g) == jnp.sign(vel)
        gains = jnp.maximum(
            jnp.where(same_sign, gains * 0.8, gains + 0.2), 0.01
        )
        momentum = jnp.where(i < early_iter, 0.5, 0.8)
        vel = momentum * vel - learning_rate * gains * g
        y = y + vel
        return y, vel, gains

    y, _, _ = lax.fori_loop(
        0, n_iter, body,
        (y0, jnp.zeros_like(y0), jnp.ones_like(y0)),
    )
    return y - jnp.mean(y, axis=0)


def tsne_embed(
    x: np.ndarray,
    *,
    perplexity: float = 30.0,
    n_iter: int = 750,
    exaggeration: float | None = None,
    early_exaggeration: float = 12.0,
    early_iter: int = 250,
    seed: int | None = 42,
    do_pca_init: bool = True,
    multiscale: bool = False,
    dof: float = 1.0,
) -> np.ndarray:
    r"""2-D t-SNE embedding of ``x`` (N, F), computed on the accelerator.

    ``multiscale`` mixes the target perplexity with ``N/100`` (the
    reference's openTSNE multiscale recipe, ``plotting.py:355-367``).
    ``exaggeration`` is the second-phase exaggeration (None = 1).
    """
    import jax
    import jax.numpy as jnp

    x = np.asarray(x, dtype=np.float32)
    n = len(x)
    if n < 3:
        raise ValueError("t-SNE needs at least 3 points")
    perplexity = float(min(perplexity, max((n - 1) / 3.0, 2.0)))

    xd = jnp.asarray(x)
    d2 = _pairwise_sq_dists(xd)
    p_cond = _calibrate_rows(d2, perplexity)
    if multiscale:
        p2 = _calibrate_rows(d2, max(min(n / 100.0, (n - 1) / 3.0), 2.0))
        p_cond = 0.5 * (p_cond + p2)
    p = (p_cond + p_cond.T) / (2.0 * n)

    if do_pca_init:
        xc = x - x.mean(0)
        # Deterministic PCA init scaled to std 1e-4 (openTSNE convention)
        _u, _s, vt = np.linalg.svd(xc, full_matrices=False)
        init = xc @ vt[:2].T
        init = init / max(np.std(init[:, 0]), 1e-12) * 1e-4
    else:
        rng = np.random.default_rng(seed)
        init = rng.normal(scale=1e-4, size=(n, 2))
    y0 = jnp.asarray(init, jnp.float32)

    y = _descend(
        p, y0, n_iter,
        float(exaggeration) if exaggeration is not None else 1.0,
        early_exaggeration, early_iter,
        learning_rate=max(n / early_exaggeration, 50.0),
        dof=float(dof),
    )
    return np.asarray(jax.block_until_ready(y))
