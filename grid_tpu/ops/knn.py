"""Depth-matched nearest-neighbor search (pipeline step 5).

Accelerator re-design of the reference's cohort kNN
(``grid/utils/find_neighbors.py``): instead of a BallTree, pairwise squared
Euclidean distances are computed as a blocked Gram matmul —
``d2(a, b) = |a|^2 + |b|^2 - 2 a.b`` — followed by a top-k selection. Row
blocks bound peak memory at O(block * N) so the full N x N distance matrix
never materializes in device memory; the matmul does 2 * N^2 * R FLOPs.

Every Gram and weight matmul in the package runs at :data:`GRAM_PRECISION`.
An f32 matmul left at the default precision may run in TF32 on a GPU, which
keeps about three decimal digits and can change which neighbours are
selected; the float64 oracle tolerances are stated at full f32 precision.

Semantics preserved (quirk Q5): distances are SQUARED Euclidean and later
normalized by 2 * R_use; self is excluded; each sample gets
min(num_neighbors, N-1) neighbors sorted ascending.

The multi-chip variant (rows cohort-sharded, ring ppermute over column
blocks with running top-k merge) lives in :mod:`grid_tpu.parallel.pknn`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Precision of every Gram and weight matmul (knn, select, pknn). Trading it
# for speed is a precision change, to be justified against the oracle.
GRAM_PRECISION = jax.lax.Precision.HIGHEST


def filter_regions_by_variance(
    sigma2ratios, frac_r: float = 1.0, sigma2_max: float = 1000.0
):
    """Host-side region filter (ref: grid/utils/find_neighbors.py:128-175).

    The lower bound sigma2_min is the value at rank ``int(R * (1 - frac_r))``
    of the ascending sort of the FINITE ratios — note the reference computes
    the rank against the TOTAL region count R, then clamps into the finite
    array (parity). Keeps finite ratios in [sigma2_min, sigma2_max].

    Returns (valid_indices ascending, R_use).
    """
    sigma2ratios = np.asarray(sigma2ratios)
    r = len(sigma2ratios)
    finite_mask = np.isfinite(sigma2ratios)
    finite_vals = np.sort(sigma2ratios[finite_mask])
    if len(finite_vals) == 0:
        return np.arange(r), r
    lower_idx = min(int(r * (1.0 - frac_r)), len(finite_vals) - 1)
    sigma2_min = float(finite_vals[lower_idx])
    valid_mask = finite_mask & (sigma2ratios >= sigma2_min) & (sigma2ratios <= sigma2_max)
    valid_indices = np.where(valid_mask)[0]
    return valid_indices, len(valid_indices)


def region_filter_mask(sigma2ratios, frac_r: float = 1.0, sigma2_max: float = 1000.0,
                       n_written=None):
    """Device-side (jit-safe) variant returning a boolean [R] mask.

    Matches :func:`filter_regions_by_variance` including the all-non-finite
    fallback (keep everything).

    Args:
        n_written: the column count the frac_r rank is computed against — in
            the file pipeline this is the number of WRITTEN columns (len of
            the header row), which the fused path must emulate when it feeds
            a full-length array with un-selected columns masked to NaN. May
            be a traced scalar. Defaults to the array length.
    """
    sigma2ratios = jnp.asarray(sigma2ratios)
    r = sigma2ratios.shape[0] if n_written is None else n_written
    finite = jnp.isfinite(sigma2ratios)
    n_finite = jnp.sum(finite)
    big = jnp.asarray(jnp.inf, dtype=sigma2ratios.dtype)
    sorted_vals = jnp.sort(jnp.where(finite, sigma2ratios, big))
    # int() truncation of r * (1 - frac_r); the epsilon guards float error
    # flipping e.g. 90.0 to 89.999996 under f32
    rank = jnp.floor(
        jnp.asarray(r, jnp.float32) * jnp.float32(1.0 - frac_r) + jnp.float32(1e-4)
    ).astype(jnp.int32)
    lower_idx = jnp.minimum(rank, jnp.maximum(n_finite - 1, 0))
    sigma2_min = sorted_vals[lower_idx]
    mask = finite & (sigma2ratios >= sigma2_min) & (sigma2ratios <= sigma2_max)
    return jnp.where(n_finite > 0, mask, jnp.ones_like(mask))


def prepare_z(z, mask, zmax: float, region_mask=None):
    """Clip z to [-zmax, zmax] and zero-fill invalid entries
    (ref: grid/utils/find_neighbors.py:57-58 — clip then NaN -> 0).

    With ``region_mask`` given, de-selected columns are zeroed as well: a
    zero column contributes 0 to every pairwise distance, which is exactly
    equivalent to dropping the column, and keeps shapes static for jit.
    """
    z = jnp.asarray(z)
    out = jnp.where(mask, jnp.clip(z, -zmax, zmax), 0)
    if region_mask is not None:
        out = out * region_mask[None, :].astype(out.dtype)
    return out


@partial(jax.jit, static_argnames=("k", "row_block", "selector", "recall_target", "col_block"))
def knn_squared(z, k: int, row_valid=None, row_block: int = 512,
                selector: str = "approx", recall_target: float = 1.0,
                col_block: int | None = None):
    """Exact k-nearest-neighbor search by blocked Gram matmul.

    Args:
        z: [N, R] prepared z-matrix (clipped, zero-filled).
        k: neighbors per row (self excluded). Must be <= N - 1.
        row_valid: optional [N] bool; invalid rows (padding) are never
            returned as neighbors and their own results are junk.
        row_block: rows per distance panel; panel memory is
            ``row_block * N * 4`` bytes.
        selector: "approx" uses ``lax.approx_max_k``; with the default
            ``recall_target=1.0`` it is an exact top-k (the CPU and GPU
            backends lower it to one). "top_k" forces ``lax.top_k``.
            "bisect" uses the exact threshold-bisection selection
            (:func:`grid_tpu.ops.select.sorted_smallest_k`) — memory-bound
            compare/count passes instead of per-row k-element selection
            state. Which selector is fastest on the GPU at each shape is
            not measured yet.
        recall_target: recall for the approx selector (1.0 = exact).
        col_block: two-stage selection width: split the N columns into
            blocks, select k per block, and exact-merge the candidates, so
            no selection runs over a very wide panel.
            None = auto: flat below 16384 columns, 8192-wide blocks above.

    Returns:
        sq_dists: [N, k] squared Euclidean distances, ascending.
        idx: [N, k] neighbor row indices.
    """
    n = z.shape[0]
    if k > n - 1:
        raise ValueError(f"k={k} must be <= N-1={n - 1}")
    if selector not in ("approx", "top_k", "bisect"):
        raise ValueError(f"unknown selector {selector!r}")
    if selector == "bisect":
        col_block = None  # bisection scans the whole row; two-stage is moot
    elif col_block is None and n > 16384:
        col_block = 8192
    if col_block is not None and (col_block >= n or col_block <= k):
        col_block = None  # two-stage has nothing to gain at these shapes

    sq_norms = jnp.sum(z * z, axis=1)  # [N]
    col_invalid = None if row_valid is None else ~jnp.asarray(row_valid, dtype=bool)
    big = jnp.asarray(jnp.finfo(z.dtype).max, dtype=z.dtype)

    # Pad rows to a block multiple; padded rows produce junk rows that are
    # sliced off, and never pollute results because only columns are masked.
    n_blocks = -(-n // row_block)
    n_pad = n_blocks * row_block
    z_pad = jnp.pad(z, ((0, n_pad - n), (0, 0)))
    sq_pad = jnp.pad(sq_norms, (0, n_pad - n))
    zt = z.T  # [R, N]

    def panel(carry, inputs):
        zb, sqb, row0 = inputs
        # Gram panel: [B, N]
        g = jnp.dot(zb, zt, precision=GRAM_PRECISION, preferred_element_type=z.dtype)
        d2 = sqb[:, None] + sq_norms[None, :] - 2 * g
        d2 = jnp.maximum(d2, 0)
        # Self-exclusion: global row ids vs column ids.
        rows = row0 + jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        d2 = jnp.where(rows == cols, big, d2)
        if col_invalid is not None:
            d2 = jnp.where(col_invalid[None, :], big, d2)
        if col_block is not None:
            # two-stage: select k per column block, exact-merge candidates;
            # the tail is padded with +inf so any N works
            b = d2.shape[0]
            ncb = -(-n // col_block)
            d2p = jnp.pad(d2, ((0, 0), (0, ncb * col_block - n)), constant_values=big)
            d3 = d2p.reshape(b, ncb, col_block)
            if selector == "approx":
                neg, idx = jax.lax.approx_max_k(-d3, k, recall_target=recall_target)
            else:
                neg, idx = jax.lax.top_k(-d3, k)
            base = (jnp.arange(ncb, dtype=jnp.int32) * col_block)[None, :, None]
            cand_d = (-neg).reshape(b, ncb * k)
            cand_i = (idx + base).reshape(b, ncb * k)
            neg2, pos = jax.lax.top_k(-cand_d, k)
            return carry, (-neg2, jnp.take_along_axis(cand_i, pos, axis=1))
        if selector == "bisect":
            from grid_tpu.ops.select import sorted_smallest_k

            return carry, sorted_smallest_k(d2, k)
        if selector == "approx":
            neg, idx = jax.lax.approx_max_k(-d2, k, recall_target=recall_target)
        else:
            neg, idx = jax.lax.top_k(-d2, k)
        return carry, (-neg, idx)

    blocks = (
        z_pad.reshape(n_blocks, row_block, -1),
        sq_pad.reshape(n_blocks, row_block),
        jnp.arange(n_blocks, dtype=jnp.int32) * row_block,
    )
    _, (sq_dists, idx) = jax.lax.scan(panel, None, blocks)
    return sq_dists.reshape(n_pad, k)[:n], idx.reshape(n_pad, k)[:n]


def d2_matrix(z, row_valid=None):
    """Materialize the full [N, N] squared-distance matrix on device, with
    the diagonal (self) and invalid-row columns set to finfo.max.

    At N=2504 this is 25 MB, small enough to run BOTH the list selection
    and the threshold dipCN against it without any [N, k] gather.
    """
    z = jnp.asarray(z)
    sq = jnp.sum(z * z, axis=1)
    g = jnp.dot(z, z.T, precision=GRAM_PRECISION)
    d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2 * g, 0)
    big = jnp.asarray(jnp.finfo(z.dtype).max, z.dtype)
    rows = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    d2 = jnp.where(rows == cols, big, d2)
    if row_valid is not None:
        d2 = jnp.where(~jnp.asarray(row_valid, bool)[None, :], big, d2)
    return d2


def knn_squared_host(z, k: int):
    """Reference-fidelity host implementation (float64 numpy) used by parity
    tests: exact pairwise distances, self-excluded, ascending with
    index-order tie-breaking."""
    z = np.asarray(z, dtype=np.float64)
    n = z.shape[0]
    k = min(k, n - 1)
    sq = np.sum(z * z, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2 * z @ z.T
    d2 = np.maximum(d2, 0.0)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, axis=1), idx
