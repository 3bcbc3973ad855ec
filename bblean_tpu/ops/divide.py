r"""Correctly rounded f32 division on every backend.

XLA:GPU lowers f32 division to ``div.full.f32``, which is within 2 ulp of
the quotient but not correctly rounded; the CPU backend divides in IEEE
round-to-nearest.  The engine's decisions compare similarities and iSIM
values that are ratios of integer counts, and such ratios tie exactly and
often: two candidates at 3/6 and 4/8, or a pair whose Tanimoto is exactly
the threshold's rational.  With an approximate quotient those ties break
by rounding noise instead of by index, and at t=0.3 the GPU found ~5% more
clusters than the CPU on the same rows.  :func:`div_rn` restores the IEEE
quotient with one correction step built only from operations both
backends round exactly (multiply, add, bit masks).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array, lax

__all__ = ["div_rn"]

_HI_MASK = 0xFFFFF000  # keep sign, exponent and the top 11 stored bits


def _hi(x: Array) -> Array:
    r"""``x`` with the low 12 mantissa bits cleared (12 significant bits),
    so products of two such halves are exact in f32."""
    bits = lax.bitcast_convert_type(x, jnp.uint32) & jnp.uint32(_HI_MASK)
    return lax.bitcast_convert_type(bits, jnp.float32)


def _div_correct(num: Array, den: Array, q: Array) -> Array:
    r"""Round ``q`` (within a few ulp of ``num / den``) to the IEEE quotient.

    The residual ``num - q * den`` is formed from the four exact partial
    products of the split operands.  For integer operands below 2^12 (the
    engine's similarity counts) every step is exact, and since
    ``num / den`` then lies at least ``ulp / (2 * den)`` from any rounding
    midpoint, ``q + r / den`` rounds to the correctly rounded quotient.
    Larger operands (iSIM sums) get the same step with a residual rounded
    to ~2^-14 of itself, which misrounds only quotients within ~2^-13 ulp
    of a midpoint.
    """
    q_hi = _hi(q)
    q_lo = q - q_hi
    d_hi = _hi(den)
    d_lo = den - d_hi
    r = num - q_hi * d_hi
    r = r - q_hi * d_lo
    r = r - q_lo * d_hi
    r = r - q_lo * d_lo
    return q + r * (1.0 / den)


def div_rn(num: Array, den: Array) -> Array:
    r"""``num / den`` in f32, correctly rounded on every backend (see the
    module docstring); ``den`` must be nonzero and finite."""
    num = jnp.asarray(num, jnp.float32)
    den = jnp.asarray(den, jnp.float32)
    return _div_correct(num, den, num / den)
