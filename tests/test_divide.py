r"""``div_rn``: the IEEE f32 quotient on every backend.

XLA:GPU's f32 division may be off by up to 2 ulp, so the correction step is
tested by feeding it quotients perturbed by -2..+2 ulp: for every integer
pair ``num <= den <= 4096`` (all similarity ratios of 2048-bit and
4096-bit fingerprints) it must return exactly ``np.float32(num / den)``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bblean_tpu.ops.divide import _div_correct, div_rn

_correct = jax.jit(_div_correct)


def _perturb(q: np.ndarray, k: int) -> np.ndarray:
    for _ in range(abs(k)):
        q = np.nextafter(q, np.float32(np.inf if k > 0 else -np.inf))
    return q.astype(np.float32)


def _pairs(lo: int, hi: int):
    nums = np.arange(lo, hi, dtype=np.float32)
    dens = np.arange(1, 4097, dtype=np.float32)
    n, d = np.meshgrid(nums, dens, indexing="ij")
    keep = n <= d
    return n[keep], d[keep]


@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_small_integer_ratios_round_exactly(ulps) -> None:
    for lo in range(0, 4097, 1024):
        n, d = _pairs(lo, min(lo + 1024, 4097))
        ref = n / d
        got = np.asarray(
            _correct(jnp.asarray(n), jnp.asarray(d), jnp.asarray(_perturb(ref, ulps)))
        )
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hi", [2**16, 2**24, 2**31])
def test_large_integer_ratios_round_exactly(hi) -> None:
    r"""iSIM numerators and denominators: integer-valued sums up to 2^31."""
    rng = np.random.default_rng(hi)
    d = rng.integers(1, hi, 500_000).astype(np.float32)
    n = np.floor(d * rng.random(500_000)).astype(np.float32)
    ref = n / d
    for ulps in (-2, -1, 1, 2):
        got = np.asarray(
            _correct(jnp.asarray(n), jnp.asarray(d), jnp.asarray(_perturb(ref, ulps)))
        )
        np.testing.assert_array_equal(got, ref)


def test_div_rn_matches_ieee_and_ties() -> None:
    n = jnp.asarray([3.0, 4.0, 0.0, 13.0, 26.0], jnp.float32)
    d = jnp.asarray([10.0, 8.0, 5.0, 20.0, 40.0], jnp.float32)
    got = np.asarray(div_rn(n, d))
    np.testing.assert_array_equal(got, np.asarray(n) / np.asarray(d))
    assert got[0] == np.float32(0.3) and got[3] == got[4] == np.float32(0.65)
