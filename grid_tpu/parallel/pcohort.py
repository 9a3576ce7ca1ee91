"""The fused cohort step over a device mesh.

Two execution strategies, both producing the same results as the
single-device :func:`grid_tpu.models.cohort.cohort_step`:

- :func:`auto_sharded_cohort_step` — GSPMD: jit the fused step with cohort
  shardings on its inputs and let XLA's partitioner insert the collectives.
  Simplest, for cohorts whose gathered z fits per-device memory.
- :func:`sharded_cohort_step` — explicit shard_map composition: psum column
  stats + ring-ppermute kNN, so the N x N distance matrix AND the full
  gathered z never materialize. This is the 100k-sample/biobank path.

Phasing operates on [2N] haplotype vectors — thousands of floats — so it
runs replicated after an all-gather of the dipCN vector (communication is
negligible next to the kNN ring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from grid_tpu.models.cohort import CohortOutputs, CohortParams, cohort_step
from grid_tpu.ops.dipcn import compute_dipcn
from grid_tpu.ops.knn import prepare_z, region_filter_mask
from grid_tpu.ops.normalize import select_high_variance_mask
from grid_tpu.ops.phasing import compute_imputed, phase_haplotypes
from grid_tpu.parallel.mesh import (
    cohort_sharding,
    replicated_sharding,
    shard_cohort_inputs,
)
from grid_tpu.parallel.pknn import ring_knn
from grid_tpu.parallel.pstats import normalize_cohort_sharded


def auto_sharded_cohort_step(mesh, params: CohortParams):
    """GSPMD variant: the fused single-device step jitted with shardings."""
    s2 = cohort_sharding(mesh, 2)
    s1 = cohort_sharding(mesh, 1)
    rep = replicated_sharding(mesh)

    def _bound(values, mask, reads, reads_valid, hap_idx, hap_w, hap_valid, row_valid):
        return cohort_step(
            values, mask, reads, reads_valid, hap_idx, hap_w, hap_valid,
            params=params, row_valid=row_valid,
        )

    # outputs: let XLA choose (row-major outputs stay cohort-sharded)
    return jax.jit(_bound, in_shardings=(s2, s2, s1, s1, rep, rep, rep, s1))


def sharded_cohort_step(
    mesh,
    values,
    mask,
    reads,
    reads_valid,
    hap_nbr_idx,
    hap_nbr_w,
    hap_nbr_valid,
    params: CohortParams = CohortParams(),
    row_valid=None,
    payload_ring: bool = True,
) -> CohortOutputs:
    """Explicit-collective variant. Host-side entry: pads + shards inputs,
    then runs psum-stats -> ring kNN -> local dipCN -> replicated phasing.

    Args:
        values/mask: [N, R] host or device arrays (any N — padded here).
        reads/reads_valid: [N].
        hap_nbr_*: [2N, K] padded haplotype neighbors (replicated).
        params: static hyperparameters.
        row_valid: pass the staged row-validity mask to skip the host-side
            pad+shard (inputs must already be [N_pad, ...] device arrays
            with cohort shardings — the :func:`stage_cohort_sharded` path,
            where the global matrix never exists on the host).
        payload_ring: False restores the r2 formulation (plain ring kNN,
            then dipCN via an all-gathered attribute vector and an [N, k]
            neighbor gather) — a MEASUREMENT knob for the ring-vs-gather
            comparison (scripts/bench_biobank.py), not a tuning choice:
            on a real multi-host pod the replication is the cost.
    """
    if row_valid is None:
        values, mask, reads, reads_valid, row_valid = shard_cohort_inputs(
            mesh, values, mask, reads, reads_valid
        )
    n_pad = values.shape[0]
    n_rows = jnp.sum(row_valid)

    # ---- step 4: sharded normalize ------------------------------------
    norm = normalize_cohort_sharded(values, mask, mesh, n_rows=n_rows)
    selected = select_high_variance_mask(norm.var_ratio, params.top_frac)

    from grid_tpu.models.cohort import _q2

    scales = norm.row_means_raw
    z = norm.z
    if params.quantize:
        scales = _q2(scales)
        z = jnp.where(norm.mask, _q2(z), z)

    # ---- step 5: region filter + ring kNN ------------------------------
    ratios_seen = jnp.where(selected, norm.var_ratio, jnp.nan)
    vfilter = region_filter_mask(
        ratios_seen, params.frac_r, params.sigma2_max, n_written=jnp.sum(selected)
    )
    region_used = selected & vfilter
    r_use = jnp.sum(region_used)

    zp = prepare_z(z, norm.mask, params.zmax, region_mask=region_used)
    sample_ok = jnp.any(norm.mask, axis=1) & row_valid

    # ---- steps 5+6: ring kNN with dipCN payloads carried through --------
    # Each row's dipCN contribution (reads/scale) and usability ride the
    # ring WITH the candidate rows, so step 6 needs neither the replicated
    # reads/scales vectors nor the [N, k] neighbor gather — the gather-free
    # formulation extended to the sharded path. Payload merge cost is
    # O(B*k) per ring step, small next to the [B, B] matmul.
    usable_row = reads_valid & sample_ok
    w_row = jnp.where(usable_row, jnp.asarray(reads), 0) / jnp.where(
        scales == 0, 1, scales
    )
    rep = replicated_sharding(mesh)
    if payload_ring:
        sq_dists, nbr_idx, nbr_contrib, nbr_usable = ring_knn(
            zp, params.num_neighbors, mesh, row_valid=sample_ok,
            payloads=(w_row, usable_row),
        )
    else:
        sq_dists, nbr_idx = ring_knn(
            zp, params.num_neighbors, mesh, row_valid=sample_ok
        )
        w_all = jax.jit(lambda x: x, out_shardings=rep)(w_row)
        u_all = jax.jit(lambda x: x, out_shardings=rep)(usable_row)
        nbr_contrib = w_all[nbr_idx]
        nbr_usable = u_all[nbr_idx]

    dipcn, dipcn_valid = compute_dipcn(
        jnp.asarray(reads) / scales,
        usable_row,
        nbr_contrib,
        nbr_usable,
        n_nbr=params.n_nbr,
    )

    # ---- step 7: replicated phasing ------------------------------------
    irrs = jnp.where(dipcn_valid, dipcn, jnp.nan)
    n_samp = hap_nbr_idx.shape[0] // 2
    irrs_g = jax.jit(lambda x: x[:n_samp], out_shardings=rep)(irrs)
    phasing = phase_haplotypes(
        irrs_g, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params.min_nbr, params.n_iters
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
