"""Cohort depth-matrix normalization (pipeline step 4's numeric heart).

Re-derivation of the reference transform
(``grid/utils/normalize_mosdepth.py:419-476``; math spec
``docs/source/algorithms/normalization.rst:28-100``) as a single fused,
jittable function over an explicit ``(values, mask)`` pair:

1.  row-wise: divide each sample row by its mean depth (rows whose mean is
    0 or that have no valid entries are invalidated, matching the NaN
    propagation of ``row_means_safe``);
2.  column-wise: mu = masked mean, s2 = masked sum of squared deviations
    divided by ``N - 1`` where **N is the total row count** (the reference's
    C++-mirroring quirk — NOT the per-column valid count);
3.  variance ratio = 100 * s2 / mu for mu > 0;
4.  z-transform x -> (x - mu) / sqrt(mu) for mu > 0 columns;
5.  global rescale by 1 / sqrt(median_ratio / 100) so values approximate
    true z-scores.

Everything is branch-free jnp; under ``jit`` XLA fuses the whole transform
into a handful of passes over device memory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from grid_tpu.ops.masked import masked_mean, masked_median, masked_var_numerator


class NormalizeResult(NamedTuple):
    """Output of :func:`normalize_cohort`.

    Attributes:
        z: [N, R] normalized + rescaled z-scores (junk where ~mask).
        mask: [N, R] validity after row invalidation.
        col_means: [R] per-region mu of the row-normalized matrix (NaN where
            no valid entries) — written to header line 0.
        col_vars: [R] per-region s2 (ddof=1 over total N) — header line 1
            is 100 * col_vars / col_means.
        var_ratio: [R] 100 * s2 / mu (NaN where mu <= 0 or no data).
        row_means_raw: [N] per-sample mean RAW depth — the ``scale`` column
            (quirk Q4: 1x units, unlike the 100x coverage TSV).
        scale: scalar global rescale factor applied to z.
    """

    z: jnp.ndarray
    mask: jnp.ndarray
    col_means: jnp.ndarray
    col_vars: jnp.ndarray
    var_ratio: jnp.ndarray
    row_means_raw: jnp.ndarray
    scale: jnp.ndarray


def normalize_cohort(values, mask, ratio_mult: float = 100.0, n_rows=None) -> NormalizeResult:
    """Normalize a [N, R] masked depth matrix. See module docstring.

    Args:
        values: [N, R] raw depths (entries where ~mask are ignored).
        mask: [N, R] bool validity.
        ratio_mult: variance-ratio multiplier (reference hardcodes 100).
        n_rows: effective cohort size for the ``N - 1`` variance denominator.
            Defaults to the array's row count; pass the REAL sample count when
            rows are padded for sharding (may be a traced scalar).
    """
    values = jnp.asarray(values)
    mask = jnp.asarray(mask, dtype=bool)
    n_inds = values.shape[0] if n_rows is None else n_rows

    # -- step 1: row normalization --------------------------------------
    row_means_raw = masked_mean(values, mask, axis=1)  # NaN for empty rows
    row_ok = jnp.isfinite(row_means_raw) & (row_means_raw != 0)
    # Invalid rows become all-invalid (reference: row_mean 0 -> NaN row).
    mask = mask & row_ok[:, None]
    safe_row = jnp.where(row_ok, row_means_raw, 1)
    x = jnp.where(mask, values / safe_row[:, None], 0)

    # -- step 2: column stats -------------------------------------------
    col_cnt = jnp.sum(mask, axis=0)
    col_ok = col_cnt > 0
    col_means = masked_mean(x, mask, axis=0)  # NaN where col_cnt == 0
    safe_mu = jnp.where(col_ok, col_means, 0)
    # Denominator is total N - 1 (reference parity), not valid count.
    # An all-invalid column keeps 0.0 (np.nansum over an all-NaN slice is 0,
    # so the reference reports variance 0 there, not NaN).
    col_vars = masked_var_numerator(x, mask, safe_mu, axis=0) / (n_inds - 1)

    # -- step 3: variance ratios ----------------------------------------
    mu_pos = col_ok & (safe_mu > 0)
    var_ratio = jnp.where(mu_pos, ratio_mult * col_vars / jnp.where(mu_pos, safe_mu, 1), jnp.nan)

    # -- step 4: z-transform (only mu > 0 columns are transformed) ------
    sqrt_mu = jnp.sqrt(jnp.where(mu_pos, safe_mu, 1))
    z = jnp.where(mu_pos[None, :], (x - safe_mu[None, :]) / sqrt_mu[None, :], x)
    z = jnp.where(mask, z, 0)

    # -- step 5: median rescale -----------------------------------------
    ratio_valid = ~jnp.isnan(var_ratio)
    med = masked_median(var_ratio, ratio_valid)
    scale = jnp.where(
        ratio_valid.any() & (med > 0),
        1.0 / jnp.sqrt(med / ratio_mult),
        jnp.asarray(1.0, dtype=values.dtype),
    )
    z = z * scale

    return NormalizeResult(
        z=z,
        mask=mask,
        col_means=col_means,
        col_vars=col_vars,
        var_ratio=var_ratio,
        row_means_raw=row_means_raw,
        scale=scale,
    )


def select_high_variance_indices(var_ratio, top_frac: float = 0.1) -> np.ndarray:
    """Host-side region selection for the file-writing pipeline path.

    Reference-parity quirk Q2 (``grid/utils/normalize_mosdepth.py:479-499``):
    the threshold is the value at rank ``int(top_frac * n_valid)`` of the
    ascending sort, and regions STRICTLY ABOVE it are kept — i.e. with
    top_frac=0.1 roughly the top 90% of regions survive, despite the docs
    claiming "top 10%". Output parity requires the code's behavior.

    Returns ascending int indices into the R axis.
    """
    var_ratio = np.asarray(var_ratio)
    valid = ~np.isnan(var_ratio)
    vals = var_ratio[valid]
    if vals.size == 0:
        return np.array([], dtype=int)
    sorted_vals = np.sort(vals)
    threshold_idx = min(int(top_frac * len(sorted_vals)), len(sorted_vals) - 1)
    threshold = sorted_vals[threshold_idx]
    return np.where(valid & (var_ratio > threshold))[0]


def select_high_variance_mask(var_ratio, top_frac: float = 0.1):
    """Device-side (jit-safe) variant of :func:`select_high_variance_indices`
    returning a boolean [R] mask instead of dynamic indices.

    Used by the fused cohort step: de-selected columns are zeroed rather than
    gathered, which leaves pairwise distances and dipCN unchanged while
    keeping all shapes static.
    """
    var_ratio = jnp.asarray(var_ratio)
    valid = ~jnp.isnan(var_ratio)
    n_valid = jnp.sum(valid)
    big = jnp.asarray(jnp.inf, dtype=var_ratio.dtype)
    sorted_vals = jnp.sort(jnp.where(valid, var_ratio, big))
    threshold_idx = jnp.minimum(
        (top_frac * n_valid).astype(jnp.int32), jnp.maximum(n_valid - 1, 0)
    )
    threshold = sorted_vals[threshold_idx]
    return valid & (var_ratio > threshold) & (n_valid > 0)
