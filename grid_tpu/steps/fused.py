"""Fused execution of pipeline steps 4-7.

With ``device: {fused: true}`` the orchestrator replaces the four separate
normalize -> neighbors -> dipCN -> haploid steps (each re-reading the
previous step's gzipped TSV) with ONE staged ingest + ONE fused device
program (`grid_tpu.models.cohort.cohort_step`), then writes all four
artifacts from the device outputs. Same formats, one XLA program, no
intermediate file round-trips.

Phasing runs AFTER the fused compute, over exactly the dipCN-valid samples
(the haplotype-neighbor files are indexed against the same sample universe
the file pipeline's dipCN artifact would contain), so fused and sequential
modes share step-7 semantics exactly (both Jacobi; ``exact_phasing``
selects the byte-parity sequential pipeline).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from grid_tpu.io.bed import load_repeat_mask
from grid_tpu.io.formats import (
    neighbors_filename,
    read_counts_tsv,
    read_samples,
    write_dipcn,
    write_haploid_output,
    write_neighbors_dense,
    write_normalized_output,
)
from grid_tpu.io.hap_neighbors import (
    load_ibd_neighbors,
    load_ibs_neighbors,
    pad_hap_neighbors,
)
from grid_tpu.models.cohort import CohortParams, cohort_step
from grid_tpu.utils.device import resolve_dtype, step_device
from grid_tpu.utils.logging import log
from grid_tpu.utils.timing import step_timer


def fused_steps_enabled(config: dict) -> bool:
    """True when the fused path can replace steps 4-7."""
    if not config.get("device", {}).get("fused", False):
        return False
    if config.get("device", {}).get("exact_phasing", False):
        return False  # byte-parity mode needs the sequential step pipeline
    m = config.get("mosdepth", {})
    return all(
        section.get("run") is True
        for section in (
            m.get("normalize", {}),
            m.get("neighbors", {}),
            config.get("compute_diploid_genotypes", {}),
            config.get("compute_haploid_genotypes", {}),
        )
    )


def run_fused_steps(config, console=None, timer=None):
    """Stage once, run the fused cohort step, write all four artifacts."""
    chrom = config.get("chrom")
    start = config.get("start_bp")
    end = config.get("end_bp")
    threads = config.get("threads", 1)
    output_dir = config.get("output_dir", ".")
    out_type = config.get("output_file_type", "tsv")

    m = config["mosdepth"]
    ncfg = m["normalize"]
    kcfg = m["neighbors"]
    dcfg = config["compute_diploid_genotypes"]
    hcfg = config["compute_haploid_genotypes"]

    with step_timer("fused.stage", timer, None):
        samples = read_samples(config["samples_file"])
        excluded = load_repeat_mask(ncfg.get("repeat_mask_file")) if ncfg.get("repeat_mask_file") else {}
        from grid_tpu.steps.normalize import _stage

        stage = _stage(
            config, samples, chrom, start, end, excluded,
            ncfg.get("min_depth", 20), ncfg.get("max_depth", 100), threads, console,
        )
        counts_file = Path(output_dir) / f"{config['count_reads'].get('output_file_prefix')}.{out_type}"
        reads_map = read_counts_tsv(counts_file)
        n = len(stage.sample_ids)
        reads = np.array([reads_map.get(sid, np.nan) for sid in stage.sample_ids])
        reads_valid = np.array([sid in reads_map for sid in stage.sample_ids])

        max_nbr = hcfg.get("max_neighbors", 10)
        method = str(hcfg.get("method", "ibs")).lower()
        if method not in ("ibs", "ibd"):
            raise ValueError(f"unknown method '{method}'")
        # phasing neighbors are loaded AFTER dipCN validity is known (below),
        # against the same sample universe the file pipeline's dipCN artifact
        # would contain; the device step runs with empty placeholders
        hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], max_nbr, dtype=np.float64)

    params = CohortParams(
        top_frac=ncfg.get("top_frac", 0.1),
        zmax=kcfg.get("zmax", 2.0),
        sigma2_max=kcfg.get("sigma2_max", 1000.0),
        frac_r=kcfg.get("frac_r", 1.0),
        num_neighbors=min(kcfg.get("num_neighbors", 500), n - 1),
        n_nbr=dcfg.get("n_nbr", 300),
        min_nbr=hcfg.get("min_neighbors", 1),
        n_iters=0,  # step 7 runs separately over the dipCN-valid universe
        quantize=True,
    )

    mesh_shape = config.get("device", {}).get("mesh_shape")
    dtype = resolve_dtype(config)
    stage_values = stage.values if dtype is None else stage.values.astype(dtype)
    if mesh_shape:
        # below the crossover the ring loses to the flat op
        # (parallel/policy.py) — a configured mesh is a capability, not a
        # commitment
        from grid_tpu.parallel.policy import choose_cohort_execution

        n_dev = int(np.prod(mesh_shape))
        dispatch = str(config.get("device", {}).get("dispatch", "auto"))
        choice = choose_cohort_execution(n, n_dev, dispatch)
        if choice == "flat":
            log(console,
                f"dispatch policy: N={n} below ring crossover — running the"
                f" single-device step despite mesh_shape={mesh_shape}",
                style="info")
            mesh_shape = None
    with step_timer("fused.device", timer, None):
        if mesh_shape:
            # config-driven multi-chip execution: shard the cohort axis over
            # the requested mesh and run the explicit-collective step
            from grid_tpu.parallel import cohort_mesh, sharded_cohort_step

            mesh = cohort_mesh(n_dev)
            out = sharded_cohort_step(
                mesh, stage_values, stage.mask, reads, reads_valid,
                jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), params,
            )
            out = jax.tree.map(np.asarray, out)
            # un-pad row-indexed outputs back to the real cohort size
            out = out._replace(
                z=out.z[:n], z_mask=out.z_mask[:n], scales=out.scales[:n],
                nbr_idx=out.nbr_idx[:n], nbr_sq_dists=out.nbr_sq_dists[:n],
                dipcn=out.dipcn[:n], dipcn_valid=out.dipcn_valid[:n],
            )
        else:
            with step_device(config, stage.values.size + n * n):
                out = cohort_step(
                    jnp.asarray(stage_values), jnp.asarray(stage.mask),
                    jnp.asarray(reads), jnp.asarray(reads_valid),
                    jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), params,
                )
                out = jax.tree.map(np.asarray, out)

    # ---- step 7 over the dipCN-valid sample universe --------------------
    valid = out.dipcn_valid.astype(bool)
    vidx = np.where(valid)[0]
    valid_ids = [stage.sample_ids[i] for i in vidx]
    irrs_v = np.asarray([float(out.dipcn[i]) for i in vidx])
    id_to_ind = {sid: i for i, sid in enumerate(valid_ids)}
    if method == "ibs":
        hap_nbrs = load_ibs_neighbors(hcfg["ibs_output"], id_to_ind, max_nbr)
    else:
        hap_nbrs = load_ibd_neighbors(
            hcfg["ibd_output"], id_to_ind, max_nbr, start, end,
            min_length=hcfg.get("min_length", 0.5),
            min_match=hcfg.get("min_match", 0.70),
            weighted=hcfg.get("weighted", False),
            weight_scale=hcfg.get("weight_scale", 1_000_000),
        )
    hvi, hvw, hvv = pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)
    from grid_tpu.ops.phasing import compute_imputed, phase_haplotypes

    with step_timer("fused.phase", timer, None):
        with step_device(config, hcfg.get("n_iters", 100) * max(hvi.size, 1)):
            res7 = phase_haplotypes(
                jnp.asarray(irrs_v), jnp.asarray(hvi), jnp.asarray(hvw),
                jnp.asarray(hvv), hcfg.get("min_neighbors", 1), hcfg.get("n_iters", 100),
            )
            imp7 = np.asarray(
                compute_imputed(res7.hap_irrs, jnp.asarray(hvi), jnp.asarray(hvw),
                                jnp.asarray(hvv), res7.mean_irrs)
            )
            hap7 = np.asarray(res7.hap_irrs)

    with step_timer("fused.write", timer, None):
        # step 4 artifact
        selected_idx = np.where(out.region_selected)[0]
        norm_path = Path(output_dir) / f"{ncfg.get('output_file_prefix')}.{out_type}.gz"
        write_normalized_output(
            norm_path, stage.sample_ids, out.scales, out.z, out.z_mask,
            out.col_means, out.col_vars, selected_idx,
        )

        # step 5 artifact
        zmax = params.zmax
        nbr_path = neighbors_filename(output_dir, kcfg.get("output_file_prefix"), zmax, out_type)
        r_use = max(int(out.r_use), 1)
        write_neighbors_dense(
            nbr_path, stage.sample_ids, out.scales, out.nbr_idx,
            out.nbr_sq_dists / (2 * r_use),
        )

        # step 6 artifact
        dip_path = Path(output_dir) / f"{dcfg.get('output_file_prefix')}.{out_type}"
        write_dipcn(dip_path, valid_ids, list(irrs_v))

        # step 7 artifact (rows = dipCN-valid samples, like the file path)
        hap_path = Path(output_dir) / f"{hcfg.get('output_file_prefix')}.{out_type}"
        write_haploid_output(
            hap_path, valid_ids, irrs_v,
            hap7[0::2], hap7[1::2], imp7[0::2], imp7[1::2],
        )

    log(console, f"Fused steps 4-7 complete → {output_dir}", style="success")
    return [norm_path, nbr_path, dip_path, hap_path]
