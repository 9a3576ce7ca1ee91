"""The flagship fused cohort model: steps 4-7 as ONE device computation.

Where the reference runs four separate processes communicating through
gzipped TSVs (normalize -> find_neighbors -> compute_dipcn -> hi_inference),
grid_tpu's core execution mode traces the whole chain into a single XLA
program over static shapes:

    raw depth matrix [N, R] + read counts [N] (+ hap neighbors [2N, K])
        -> normalize (masked stats)               ~ O(N R)
        -> region selection + variance filter     (masking, not gathering)
        -> z prep (clip/fill/zero columns)
        -> kNN (blocked Gram matmul + top_k)      ~ O(N^2 R)  <- dominant
        -> dipCN (gather + prefix-masked mean)    ~ O(N k)
        -> phasing (lax.scan Jacobi sweeps)       ~ O(iters N K)

De-selected regions are ZEROED rather than dropped: a zero column contributes
nothing to any pairwise distance, so results are identical to gathering while
every shape stays static — the trick that lets the whole pipeline live under
one ``jit`` and shard cleanly over a mesh.

File-format parity note: the step-by-step pipeline (grid_tpu.steps) writes
and re-reads %.2f-quantized intermediates exactly like the reference; the
fused path optionally applies the same quantization (``quantize=True``) so
its outputs match the file pipeline to the last rounding.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from grid_tpu.ops.knn import (
    d2_matrix,
    knn_squared,
    prepare_z,
    region_filter_mask,
)
from grid_tpu.ops.normalize import normalize_cohort, select_high_variance_mask
from grid_tpu.ops.phasing import PhasingResult, compute_imputed, phase_haplotypes
from grid_tpu.ops.select import (
    dipcn_from_distances,
    dipcn_from_distances_panels,
    dipcn_from_lists,
)


class CohortParams(NamedTuple):
    """Static hyperparameters of the fused cohort step (hashable; all values
    mirror the reference config surface)."""

    top_frac: float = 0.1  # normalize: high-variance selection (quirk Q2)
    zmax: float = 2.0  # neighbors: z clip
    sigma2_max: float = 1000.0  # neighbors: variance-ratio upper bound
    frac_r: float = 1.0  # neighbors: hidden lower-bound knob
    num_neighbors: int = 5  # neighbors per sample (C++ default 500)
    n_nbr: int = 300  # dipCN: neighbors averaged
    min_nbr: int = 1  # phasing: per-hap neighbor floor
    n_iters: int = 100  # phasing sweeps
    quantize: bool = True  # mimic %.2f file round-trip of scales/z
    row_block: int = 512  # kNN panel rows (large-N path)
    dipcn_lists: bool = False  # recycle the sorted step-5 lists for the
    # dipCN thresholds (dipcn_from_lists) instead of re-bisecting d2; which
    # form is faster on the GPU is not measured yet
    # d2-resident path: materialize the [N, N] distance matrix once and run
    # selection + threshold dipCN against it (no [N, k] gathers).
    # Auto-disabled when N*N*itemsize bytes exceeds this budget; the
    # row-panel path then runs instead. 0 disables.
    d2_budget_bytes: int = 2 << 30


class CohortOutputs(NamedTuple):
    """Everything the file pipeline writes, as device arrays."""

    z: jnp.ndarray  # [N, R] normalized z-scores (masked junk elsewhere)
    z_mask: jnp.ndarray  # [N, R]
    col_means: jnp.ndarray  # [R]
    col_vars: jnp.ndarray  # [R]
    var_ratio: jnp.ndarray  # [R]
    region_selected: jnp.ndarray  # [R] bool — high-variance selection
    region_used: jnp.ndarray  # [R] bool — selected AND variance-filtered
    r_use: jnp.ndarray  # scalar — |region_used|
    scales: jnp.ndarray  # [N] per-sample scale (quantized if requested)
    nbr_idx: jnp.ndarray  # [N, k]
    nbr_sq_dists: jnp.ndarray  # [N, k] squared distances (raw, un-normalized)
    dipcn: jnp.ndarray  # [N]
    dipcn_valid: jnp.ndarray  # [N]
    hap_irrs: jnp.ndarray  # [2N]
    hap_imp: jnp.ndarray  # [2N]
    phased: jnp.ndarray  # [N]
    mean_irrs: jnp.ndarray  # scalar


def _q2(x):
    """Quantize to 2 decimals (round-half-even), matching %.2f file writes."""
    return jnp.round(x * 100) / 100


@partial(jax.jit, static_argnames=("params",))
def cohort_step(
    values,
    mask,
    reads,
    reads_valid,
    hap_nbr_idx,
    hap_nbr_w,
    hap_nbr_valid,
    params: CohortParams = CohortParams(),
    row_valid=None,
) -> CohortOutputs:
    """Run normalize -> kNN -> dipCN -> phasing fused on device.

    Args:
        values: [N, R] raw binned depths.
        mask: [N, R] validity of each depth cell.
        reads: [N] VNTR-window read counts (junk where ~reads_valid).
        reads_valid: [N] bool.
        hap_nbr_idx/w/valid: [2N, K] padded haplotype neighbors
            (see grid_tpu.io.hap_neighbors.pad_hap_neighbors).
        params: static hyperparameters.
        row_valid: optional [N] bool marking padding rows (for sharded
            execution); invalid rows are excluded from all statistics.
    """
    values = jnp.asarray(values)
    mask = jnp.asarray(mask, dtype=bool)
    n_rows = None
    if row_valid is not None:
        row_valid = jnp.asarray(row_valid, dtype=bool)
        mask = mask & row_valid[:, None]
        n_rows = jnp.sum(row_valid)  # padding must not inflate the N-1 denom

    # ---- step 4: normalize + select ------------------------------------
    norm = normalize_cohort(values, mask, n_rows=n_rows)
    selected = select_high_variance_mask(norm.var_ratio, params.top_frac)

    scales = norm.row_means_raw
    z = norm.z
    if params.quantize:
        scales = _q2(scales)
        z = jnp.where(norm.mask, _q2(z), z)

    # ---- step 5: region variance filter + kNN --------------------------
    # The neighbors step recomputes ratios from the WRITTEN (selected)
    # columns; on unselected columns the filter never sees them. Emulate by
    # feeding NaN for unselected regions (reference reads only Rwant cols).
    ratios_seen = jnp.where(selected, norm.var_ratio, jnp.nan)
    vfilter = region_filter_mask(
        ratios_seen, params.frac_r, params.sigma2_max,
        n_written=jnp.sum(selected),  # rank base = written-column count
    )
    region_used = selected & vfilter
    r_use = jnp.sum(region_used)

    # Rows with no surviving cells mirror the reference's host-side
    # filter_empty_samples (grid/utils/normalize_mosdepth.py:576-600): they
    # never appear in the written matrix, so they must not be selectable as
    # neighbors nor contribute reads to dipCN means.
    sample_ok = norm.mask.any(axis=1)
    if row_valid is not None:
        sample_ok = sample_ok & row_valid
    n = values.shape[0]
    d2_resident = (
        params.d2_budget_bytes > 0
        and n * n * jnp.dtype(values.dtype).itemsize <= params.d2_budget_bytes
    )
    if d2_resident:
        # d2-resident fast path: one [N, N] distance matrix feeds both the
        # neighbor-list selection (approx_max_k, exact at recall 1.0) and
        # the gather-free threshold dipCN below.
        if params.num_neighbors > n - 1:
            raise ValueError(f"k={params.num_neighbors} must be <= N-1={n - 1}")
        zp = prepare_z(z, norm.mask, params.zmax, region_mask=region_used)
        d2 = d2_matrix(zp, row_valid=sample_ok)
        # recall_target=1.0 is REQUIRED: a lower target lets a backend
        # lower approx_max_k to a genuinely approximate selection, silently
        # breaking the parity contract for the written neighbor lists.
        # (CPU and GPU lower it to an exact top-k either way, so tests
        # can't catch a regression here — tests/test_fused_pipeline.py
        # pins it by source inspection.)
        neg, nbr_idx = jax.lax.approx_max_k(
            -d2, params.num_neighbors, recall_target=1.0
        )
        sq_dists = -neg
    else:
        zp = prepare_z(z, norm.mask, params.zmax, region_mask=region_used)
        sq_dists, nbr_idx = knn_squared(
            zp, params.num_neighbors, row_valid=sample_ok, row_block=params.row_block
        )

    # ---- step 6: dipCN -------------------------------------------------
    reads = jnp.asarray(reads)
    reads_valid = jnp.asarray(reads_valid, dtype=bool) & sample_ok
    if d2_resident:
        # threshold dipCN: no [N, k] gathers; exact stable-tie parity with
        # the reference's sorted neighbor prefix (ops/select.py).
        # dipcn_lists=True recycles the sorted step-5 lists instead of
        # re-bisecting d2 (same take-set).
        w = reads / scales
        if params.dipcn_lists:
            dipcn, dipcn_valid = dipcn_from_lists(
                d2, sq_dists, nbr_idx, w, w, reads_valid, reads_valid,
                k=params.num_neighbors, n_nbr=params.n_nbr,
            )
        else:
            dipcn, dipcn_valid = dipcn_from_distances(
                d2, w, w, reads_valid, reads_valid,
                k=params.num_neighbors, n_nbr=params.n_nbr,
            )
    else:
        # beyond the d2 budget the SAME gather-free formulation streams row
        # panels (ops/select.py:dipcn_from_distances_panels). Distance
        # geometry is masked by sample_ok (a read-less sample still
        # occupies k-slots), identical to the resident branch.
        w = reads / scales
        dipcn, dipcn_valid = dipcn_from_distances_panels(
            zp, w, w, reads_valid, reads_valid,
            k=params.num_neighbors, n_nbr=params.n_nbr,
            row_block=params.row_block, row_valid=sample_ok,
        )

    # ---- step 7: phasing ----------------------------------------------
    # Samples without a dipCN estimate are absent from the reference's dipCN
    # file and never enter phasing; NaN marks them excluded here.
    irrs = jnp.where(dipcn_valid, dipcn, jnp.nan)
    phasing: PhasingResult = phase_haplotypes(
        irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params.min_nbr, params.n_iters
    )
    imp = compute_imputed(
        phasing.hap_irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, phasing.mean_irrs
    )

    return CohortOutputs(
        z=z,
        z_mask=norm.mask,
        col_means=norm.col_means,
        col_vars=norm.col_vars,
        var_ratio=norm.var_ratio,
        region_selected=selected,
        region_used=region_used,
        r_use=r_use,
        scales=scales,
        nbr_idx=nbr_idx,
        nbr_sq_dists=sq_dists,
        dipcn=dipcn,
        dipcn_valid=dipcn_valid,
        hap_irrs=phasing.hap_irrs,
        hap_imp=imp,
        phased=phasing.phased,
        mean_irrs=phasing.mean_irrs,
    )


def make_cohort_step(params: CohortParams):
    """Bind params statically; returns fn(values, mask, reads, reads_valid,
    hap_nbr_idx, hap_nbr_w, hap_nbr_valid) -> CohortOutputs, ready for jit /
    pjit with shardings."""

    def step(values, mask, reads, reads_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid):
        return cohort_step(
            values, mask, reads, reads_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params
        )

    return step
