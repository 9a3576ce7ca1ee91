"""Tests that need a GPU (``-m gpu``; the ``gpu`` fixture skips them
elsewhere): the fused cohort step at f32 on the card against the float64
oracle, with the tolerances chip_smoke.py states."""

import numpy as np
import pytest


@pytest.mark.gpu
def test_cohort_step_panel_path_matches_oracle(gpu, smoke):
    import jax
    import jax.numpy as jnp

    from grid_tpu.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu.models.cohort import CohortParams, cohort_step

    n, r = 2048, 256
    values, mask, reads = smoke.cohort_matrix(n, r, seed=5)
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 1)
    params = CohortParams(num_neighbors=100, n_nbr=60, n_iters=0, quantize=False,
                          d2_budget_bytes=1 << 20)
    with jax.default_device(gpu):
        out = cohort_step(*[jnp.asarray(a) for a in (values, mask, reads, np.ones(n, bool),
                                                      hi, hw, hv)], params=params)
    rows = np.arange(0, n, 16)
    smoke.check_rows_against_oracle(smoke.oracle_geometry(values, mask, params), reads, rows,
                                    np.asarray(out.nbr_idx)[rows],
                                    np.asarray(out.dipcn)[rows], params, "gpu-test")
