"""Device mesh construction and sharding helpers.

The cohort (sample) axis is grid_tpu's data-parallel axis — the device
re-expression of the reference's only parallelism (thread pools over samples,
SURVEY §2.5). A 1-D ``cohort`` mesh shards matrix rows across GPUs/hosts;
collectives (psum for column statistics, ppermute rings for kNN) are
lowered by XLA (NCCL over NVLink between the GPUs of one host).

Multi-host entry: call :func:`init_distributed` once per process, then
``cohort_mesh()`` builds the global mesh over all processes' devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COHORT_AXIS = "cohort"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed for multi-host pods (no-op if single)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def cohort_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the cohort axis.

    Args:
        n_devices: use the first n devices (default: all).
        devices: explicit device list (overrides n_devices).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (COHORT_AXIS,))


def cohort_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Rows sharded over the cohort axis, remaining dims replicated."""
    spec = [COHORT_AXIS] + [None] * (ndim - 1)
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_rows(arr, multiple: int, fill=0):
    """Pad axis 0 to a multiple (returns padded array + original length)."""
    n = arr.shape[0]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return arr, n
    widths = [(0, n_pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(np.asarray(arr), widths, constant_values=fill), n


def shard_cohort_inputs(mesh: Mesh, values, mask, reads, reads_valid):
    """Pad rows to the mesh size and device_put with cohort shardings.

    Returns (values, mask, reads, reads_valid, row_valid) on device, where
    row_valid marks the original (non-padding) rows.
    """
    n_dev = mesh.devices.size
    values_p, n = pad_rows(np.asarray(values), n_dev)
    mask_p, _ = pad_rows(np.asarray(mask), n_dev, fill=False)
    reads_p, _ = pad_rows(np.asarray(reads), n_dev)
    rv_p, _ = pad_rows(np.asarray(reads_valid), n_dev, fill=False)
    row_valid = np.zeros(values_p.shape[0], dtype=bool)
    row_valid[:n] = True

    s2 = cohort_sharding(mesh, 2)
    s1 = cohort_sharding(mesh, 1)
    return (
        jax.device_put(values_p, s2),
        jax.device_put(mask_p, s2),
        jax.device_put(reads_p, s1),
        jax.device_put(rv_p, s1),
        jax.device_put(row_valid, s1),
    )
