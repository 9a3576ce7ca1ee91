"""Step 7: haplotype copy-number inference.

File-compatible with the reference step (grid/utils/hi_inference.py:253):
reads the dipCN file, loads IBS (computeIBSpbwt) or IBD (iLASH) haplotype
neighbors, runs the iterative phasing, writes
``ID IRRs hap1phased hap2phased hap1imp hap2imp``.

Two execution modes:
- device (default): padded arrays + lax.scan Jacobi sweeps;
- exact (``device.exact_phasing: true``): host Gauss-Seidel matching the
  reference's in-place update order bit-for-bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import jax.numpy as jnp

from grid_tpu.io.formats import read_dipcn, write_haploid_output
from grid_tpu.io.hap_neighbors import (
    load_ibd_neighbors,
    load_ibs_neighbors,
    pad_hap_neighbors,
)
from grid_tpu.ops.phasing import (
    compute_imputed,
    compute_imputed_host,
    phase_bootstrap,
    phase_gauss_seidel_host,
    phase_haplotypes,
)
from grid_tpu.utils.device import step_device
from grid_tpu.utils.logging import log
from grid_tpu.utils.timing import step_timer


def hi_inference(config, console=None):
    hi_cfg = config.get("compute_haploid_genotypes", {})
    output_file_prefix = hi_cfg.get("output_file_prefix", "haploid_genotypes")
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_file = Path(f"{output_dir}/{output_file_prefix}.{output_file_type}")

    dip_cn_file_prefix = config["compute_diploid_genotypes"].get("output_file_prefix")
    dip_cn_file = Path(f"{output_dir}/{dip_cn_file_prefix}.{output_file_type}")

    method = str(hi_cfg.get("method", "ibs")).lower()
    min_nbr = hi_cfg.get("min_neighbors", 1)
    max_nbr = hi_cfg.get("max_neighbors", 10)
    n_iters = hi_cfg.get("n_iters", 100)
    exact = bool(config.get("device", {}).get("exact_phasing", False))

    ids, irrs, id_to_ind = read_dipcn(dip_cn_file)
    n = len(irrs)
    log(console, f"Read diploid IRR data for {n} samples", style="success")

    if method == "ibs":
        ibs_output = hi_cfg.get("ibs_output")
        if not ibs_output:
            raise ValueError("ibs_output required for method='ibs'")
        log(console, f"Loading IBS neighbors from {ibs_output}")
        hap_nbrs = load_ibs_neighbors(ibs_output, id_to_ind, max_nbr)
    elif method == "ibd":
        ibd_output = hi_cfg.get("ibd_output")
        if not ibd_output:
            raise ValueError("ibd_output required for method='ibd'")
        log(console, f"Loading IBD neighbors from {ibd_output}")
        hap_nbrs = load_ibd_neighbors(
            ibd_output,
            id_to_ind,
            max_nbr,
            config.get("start_bp"),
            config.get("end_bp"),
            min_length=hi_cfg.get("min_length", 0.5),
            min_match=hi_cfg.get("min_match", 0.70),
            weighted=hi_cfg.get("weighted", False),
            weight_scale=hi_cfg.get("weight_scale", 1_000_000),
        )
    else:
        raise ValueError(f"unknown method '{method}', must be 'ibs' or 'ibd'")

    with step_timer("haploid.phase", console=None):
        if exact:
            hap_irrs, mean_irrs, _ = phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr, n_iters)
            imp = np.empty(2 * n)
            for i in range(n):
                imp[2 * i], imp[2 * i + 1] = compute_imputed_host(i, hap_irrs, hap_nbrs, mean_irrs)
            hap_irrs = np.asarray(hap_irrs)
        else:
            nbr_idx, nbr_w, nbr_valid = pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)
            with step_device(config, n_iters * nbr_idx.size):
                res = phase_haplotypes(
                    jnp.asarray(np.asarray(irrs)),
                    jnp.asarray(nbr_idx),
                    jnp.asarray(nbr_w),
                    jnp.asarray(nbr_valid),
                    min_nbr=min_nbr,
                    n_iters=n_iters,
                )
                imp = np.asarray(
                    compute_imputed(res.hap_irrs, jnp.asarray(nbr_idx), jnp.asarray(nbr_w),
                                    jnp.asarray(nbr_valid), res.mean_irrs)
                )
                hap_irrs = np.asarray(res.hap_irrs)

    write_haploid_output(
        output_file,
        ids,
        irrs,
        hap_irrs[0::2],
        hap_irrs[1::2],
        imp[0::2],
        imp[1::2],
    )
    log(console, f"Haploid genotypes written to {output_file}", style="success")

    n_boot = int(hi_cfg.get("bootstrap_replicates", 0))
    if n_boot > 0:
        import jax

        nbr_idx, nbr_w, nbr_valid = pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)
        with step_timer("haploid.bootstrap", console=None):
            with step_device(config, n_boot * n_iters * max(nbr_idx.size, 1)):
                mean_b, sd_b, _ = phase_bootstrap(
                    jax.random.PRNGKey(int(hi_cfg.get("bootstrap_seed", 0))),
                    jnp.asarray(np.asarray(irrs)), jnp.asarray(nbr_idx),
                    jnp.asarray(nbr_w), jnp.asarray(nbr_valid),
                    min_nbr, n_iters, n_boot=n_boot,
                )
        mean_b, sd_b = np.asarray(mean_b), np.asarray(sd_b)
        boot_file = Path(f"{output_dir}/{output_file_prefix}_bootstrap.{output_file_type}")
        with open(boot_file, "w") as f:
            f.write("ID\thap1_mean\thap1_sd\thap2_mean\thap2_sd\n")
            for i, sid in enumerate(ids):
                f.write(
                    f"{sid}\t{mean_b[2*i]:.3f}\t{sd_b[2*i]:.3f}\t"
                    f"{mean_b[2*i+1]:.3f}\t{sd_b[2*i+1]:.3f}\n"
                )
        log(console, f"Bootstrap uncertainty ({n_boot} replicates) → {boot_file}", style="success")
    return output_file
