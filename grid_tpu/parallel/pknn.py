"""Distributed k-nearest-neighbor search: ring ppermute over row blocks.

The cross-shard kNN (SURVEY §7): the z-matrix is row-sharded over the cohort
axis and the full N x N distance matrix must never materialize. Each device
keeps its local row block resident and a "visiting" block circulates around
the ring: at step s every device computes distances of its local rows
against the visiting block (one Gram matmul), folds the result into its
running top-k, and forwards the block with ``ppermute``. After n_devices
steps every local row has seen every column exactly once.

Peak memory per device: O(B * (R + k + B)); communication: each device
sends/receives the block n_devices-1 times — bandwidth-optimal for a ring
(same volume as one all_gather) and overlappable with the matmul by XLA.

The merge keeps (distance, global index) pairs; candidates are folded with
concat + re-top_k, which preserves ascending distance order. EXACT distance
ties are broken by ring visit order (own shard first, then each arriving
block), which can differ from the single-device low-index rule — quantized
z-values make exact ties possible, so cross-shard parity is asserted on
neighbor SETS and downstream dipCN, not orderings (docs/parity.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from grid_tpu.ops.knn import GRAM_PRECISION
from grid_tpu.parallel.mesh import COHORT_AXIS


def ring_knn(z, k: int, mesh, row_valid=None, payloads=()):
    """kNN over a cohort-sharded z matrix.

    Args:
        z: [N, R] cohort-sharded (N divisible by mesh size).
        k: neighbors per row (< number of valid rows).
        mesh: 1-D cohort mesh.
        row_valid: [N] bool cohort-sharded; False rows (padding) are never
            returned as neighbors.
        payloads: tuple of [N] cohort-sharded per-row attribute arrays to
            carry THROUGH the ring alongside the candidates (each visiting
            block brings its rows' attributes; the top-k merge keeps them
            aligned with the selected neighbors). The returned [N, k]
            attribute arrays make the downstream [N]-indexed neighbor
            gather unnecessary — on a multi-host mesh that gather would
            also need the attribute vector replicated.

    Returns (sq_dists [N, k], idx [N, k], *carried [N, k]) cohort-sharded,
    ascending by distance.
    """
    n_dev = mesh.devices.size
    n = z.shape[0]
    if row_valid is None:
        row_valid = jnp.ones((n,), dtype=bool)
    payloads = tuple(jnp.asarray(p) for p in payloads)

    def kernel(z_local, valid_local, *pay_local):
        b = z_local.shape[0]
        me = jax.lax.axis_index(COHORT_AXIS)
        sq_local = jnp.sum(z_local * z_local, axis=1)
        big = jnp.asarray(jnp.finfo(z_local.dtype).max, dtype=z_local.dtype)

        my_rows = me * b + jax.lax.iota(jnp.int32, b)  # global row ids

        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def step(s, carry):
            block, block_valid, block_pay, best_d, best_i, best_p = carry
            owner = (me - s) % n_dev  # which shard the visiting block came from
            # distance panel: [B, B]
            g = jnp.dot(z_local, block.T, precision=GRAM_PRECISION,
                        preferred_element_type=z_local.dtype)
            block_sq = jnp.sum(block * block, axis=1)
            d2 = sq_local[:, None] + block_sq[None, :] - 2 * g
            d2 = jnp.maximum(d2, 0)
            cols = owner * b + jax.lax.iota(jnp.int32, b)  # global col ids
            self_mask = my_rows[:, None] == cols[None, :]
            d2 = jnp.where(self_mask | ~block_valid[None, :], big, d2)
            # fold into running top-k
            cat_d = jnp.concatenate([best_d, d2], axis=1)
            cat_i = jnp.concatenate([best_i, jnp.broadcast_to(cols[None, :], d2.shape)], axis=1)
            neg, pos = jax.lax.top_k(-cat_d, k)
            best_d = -neg
            best_i = jnp.take_along_axis(cat_i, pos, axis=1)
            best_p = tuple(
                jnp.take_along_axis(
                    jnp.concatenate(
                        [bp, jnp.broadcast_to(pb[None, :], d2.shape).astype(bp.dtype)],
                        axis=1,
                    ),
                    pos, axis=1,
                )
                for bp, pb in zip(best_p, block_pay)
            )
            # forward the visiting block around the ring
            block = jax.lax.ppermute(block, COHORT_AXIS, perm)
            block_valid = jax.lax.ppermute(block_valid, COHORT_AXIS, perm)
            block_pay = tuple(
                jax.lax.ppermute(pb, COHORT_AXIS, perm) for pb in block_pay
            )
            return block, block_valid, block_pay, best_d, best_i, best_p

        # Constant-initialized carries must be marked device-varying over the
        # mesh axis (jax>=0.8 shard_map vma typing), since the loop outputs are.
        if hasattr(jax.lax, "pcast"):  # jax>=0.9 name; pvary deprecated
            _vary = lambda x: jax.lax.pcast(x, COHORT_AXIS, to="varying")
        else:
            _vary = lambda x: jax.lax.pvary(x, COHORT_AXIS)
        init = (
            z_local,
            valid_local,
            tuple(pay_local),
            _vary(jnp.full((b, k), big, dtype=z_local.dtype)),
            _vary(jnp.zeros((b, k), dtype=jnp.int32)),
            tuple(_vary(jnp.zeros((b, k), dtype=p.dtype)) for p in pay_local),
        )
        _, _, _, best_d, best_i, best_p = jax.lax.fori_loop(0, n_dev, step, init)
        return (best_d, best_i) + best_p

    sharded = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(COHORT_AXIS, None), P(COHORT_AXIS))
        + (P(COHORT_AXIS),) * len(payloads),
        out_specs=(P(COHORT_AXIS, None),) * (2 + len(payloads)),
    )
    return jax.jit(sharded)(z, row_valid, *payloads)
