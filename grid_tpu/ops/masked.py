"""Masked-array reduction primitives.

The reference leans on numpy NaN propagation (``np.nanmean`` /
``np.nansum``, grid/utils/normalize_mosdepth.py:440-458). On an accelerator,
NaN-based control flow is hostile to XLA fusion, so grid_tpu carries an
explicit ``(values, mask)`` pair everywhere and reduces with ``jnp.where`` —
branch-free, fusable, and identical in semantics at float64.

All functions preserve the input dtype and are jit/vmap/shard_map safe.
"""

from __future__ import annotations

import jax.numpy as jnp


def masked_mean(values, mask, axis=None):
    """Mean over ``mask``-valid entries; positions with zero valid count
    return NaN (matching ``np.nanmean`` of an all-NaN slice)."""
    v = jnp.where(mask, values, 0)
    cnt = jnp.sum(mask, axis=axis)
    s = jnp.sum(v, axis=axis)
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)


def masked_var_numerator(values, mask, means, axis=0):
    """Sum over valid entries of (x - mean)^2 along ``axis``.

    This is the numerator of the reference's column variance
    ``np.nansum((mat - col_means) ** 2, axis=0)``
    (grid/utils/normalize_mosdepth.py:446). The caller divides by
    ``n_rows - 1`` — the TOTAL row count, not the valid count — to match the
    C++-mirroring ddof convention exactly.
    """
    centered = jnp.where(mask, values - means, 0)
    return jnp.sum(centered * centered, axis=axis)


def masked_median(values, mask):
    """Median over valid entries of a 1-D array, matching ``np.median``
    (average of the two middle elements for even counts).

    Invalid entries sort to +inf; the two middle ranks of the valid prefix
    are gathered dynamically (jit-safe, static shapes).
    Returns NaN when nothing is valid.
    """
    values = jnp.asarray(values)
    big = jnp.asarray(jnp.inf, dtype=values.dtype)
    sortable = jnp.where(mask, values, big)
    s = jnp.sort(sortable)
    n_valid = jnp.sum(mask)
    lo = jnp.maximum((n_valid - 1) // 2, 0)
    hi = jnp.maximum(n_valid // 2, 0)
    med = (s[lo] + s[hi]) / 2
    return jnp.where(n_valid > 0, med, jnp.nan)
