"""Step 5: find depth-matched nearest neighbors.

File-compatible with the reference step (grid/utils/find_neighbors.py:11):
reads the normalized matrix, clips/fills z on device, filters regions by
variance ratio, runs the blocked Gram-matmul kNN, writes the neighbors format with
squared distances / (2 * R_use) (quirk Q5).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from grid_tpu.io.formats import neighbors_filename, read_normalized_data, write_neighbors
from grid_tpu.ops.knn import filter_regions_by_variance, knn_squared, prepare_z
from grid_tpu.utils.device import step_device
from grid_tpu.utils.logging import log
from grid_tpu.utils.timing import step_timer


def load_neighbor_geometry(config, console=None):
    """The distance geometry of the neighbors step, straight from the
    WRITTEN normalized matrix: (sample_ids, zp, scales, r_use, k).

    ``zp`` is the [N, R_use] prepared z (clip/fill + variance filter) whose
    pairwise distances define both the neighbor lists this step writes and
    the gather-free threshold dipCN — one source of truth, so the batched
    multi-locus dipCN (steps/multilocus.py) cannot drift from
    :func:`find_neighbors`.
    """
    ncfg = config["mosdepth"]["neighbors"]
    zmax = ncfg.get("zmax", 2.0)
    sigma2_max = ncfg.get("sigma2_max", 1000.0)
    n_neighbors = ncfg.get("num_neighbors", 500)
    frac_r = ncfg.get("frac_r", 1.0)

    input_file_prefix = config["mosdepth"]["normalize"].get("output_file_prefix")
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    input_file = f"{output_dir}/{input_file_prefix}.{output_file_type}.gz"

    sample_ids, sigma2ratios, data_matrix, scales = read_normalized_data(input_file)
    n = len(sample_ids)

    valid_indices, r_use = filter_regions_by_variance(sigma2ratios, frac_r, sigma2_max)
    extreme = int(np.sum(sigma2ratios > sigma2_max))
    if extreme:
        log(console, f"Removed {extreme} / {len(sigma2ratios)} regions with sigma2ratio > {sigma2_max}", style="warning")

    mask = ~np.isnan(data_matrix)
    with step_device(config, data_matrix.size):
        zp = prepare_z(jnp.asarray(np.nan_to_num(data_matrix)), jnp.asarray(mask), zmax)
        zp = zp[:, valid_indices]
    k = min(n_neighbors, n - 1)
    return sample_ids, zp, scales, r_use, k


def find_neighbors(config, console=None):
    ncfg = config["mosdepth"]["neighbors"]
    zmax = ncfg.get("zmax", 2.0)
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_prefix = ncfg.get("output_file_prefix", "neighbor_coverage")
    output_file = neighbors_filename(output_dir, output_prefix, zmax, output_file_type)

    sample_ids, zp, scales, r_use, k = load_neighbor_geometry(config, console)
    n = len(sample_ids)

    with step_timer("neighbors.device", console=None):
        with step_device(config, zp.size + zp.shape[0] ** 2):
            sq_dists, idx = knn_squared(zp, k)
            sq_dists = np.asarray(sq_dists)
            idx = np.asarray(idx)

    r_use_div = max(r_use, 1)  # guard (ref: find_neighbors.py:258-259)
    nbr_ids = [[sample_ids[j] for j in idx[i]] for i in range(n)]
    nbr_scales = [[scales[sample_ids[j]] for j in idx[i]] for i in range(n)]
    nbr_dists = [list(sq_dists[i] / (2 * r_use_div)) for i in range(n)]
    write_neighbors(output_file, sample_ids, scales, nbr_ids, nbr_scales, nbr_dists)
    log(console, f"Saved neighbors to {output_file}", style="success")
    return output_file
