"""Every Gram and weight matmul runs at the stated precision.

An f32 dot left at the default precision may run in TF32 on a GPU (about
three decimal digits), which can change the selected neighbours; the
oracle tolerances are stated at ``GRAM_PRECISION``. Each case traces one
matmul site and reads ``precision`` from its jaxpr.
"""

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest

from grid_tpu.ops.knn import GRAM_PRECISION, d2_matrix, knn_squared
from grid_tpu.ops.select import dipcn_from_distances_multi, dipcn_from_distances_panels
from grid_tpu.parallel import cohort_mesh
from grid_tpu.parallel.pknn import ring_knn


def _dot_precisions(jaxpr):
    """The precision config of every dot_general in a jaxpr, sub-jaxprs
    (jit, scan, shard_map bodies) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    out += _dot_precisions(sub)
    return out


N, R, K = 16, 8, 3
Z = jnp.asarray(np.random.default_rng(0).normal(size=(N, R)), jnp.float32)
W = jnp.ones((N,), jnp.float32)
OK = jnp.ones((N,), bool)

SITES = {
    "knn_squared": lambda: knn_squared(Z, K, row_block=8),
    "d2_matrix": lambda: d2_matrix(Z),
    "dipcn_from_distances_multi": lambda: dipcn_from_distances_multi(
        d2_matrix(Z), jnp.ones((N, 2)), jnp.ones((N, 2)), OK, jnp.ones((N, 2), bool),
        k=K, n_nbr=2),
    "dipcn_from_distances_panels": lambda: dipcn_from_distances_panels(
        Z, W, W, OK, OK, k=K, n_nbr=2, row_block=8),
    "ring_knn": lambda: ring_knn(Z, K, cohort_mesh(2)),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_matmul_precision_is_stated(site):
    precisions = _dot_precisions(jax.make_jaxpr(SITES[site])().jaxpr)
    assert precisions, f"{site}: no matmul traced"
    want = (GRAM_PRECISION, GRAM_PRECISION)
    assert all(p == want for p in precisions), (site, precisions)
