"""Dispatch policy: flat (single-device) vs ring (sharded) kNN.

Below a cohort-size crossover the ring's per-step collective + merge
overhead dominates the O(N^2 R / n_dev) work it saves, so a config that
sets ``device.mesh_shape`` for a small cohort would pay for the mesh
without gaining from it. The fused step consults this policy instead of
following the config blindly.

The crossover is a row count. It was bracketed on an 8-virtual-device CPU
mesh (scripts/bench_mesh_sweep.py), not on GPUs: it is a property of the
ratio collective latency : matmul throughput, and has to be re-derived on
the GPU mesh. ``device.dispatch: flat|ring`` overrides the policy for
measurement runs.
"""

from __future__ import annotations

RING_CROSSOVER_N = 16_384


def choose_cohort_execution(n: int, n_devices: int, dispatch: str = "auto") -> str:
    """Pick ``"flat"`` or ``"ring"`` for a cohort of ``n`` rows.

    Args:
        n: cohort row count.
        n_devices: devices in the configured mesh (1 forces flat).
        dispatch: ``auto`` applies the measured crossover; ``flat``/``ring``
            force a path (e.g. for sweeps re-measuring the crossover).
    """
    if dispatch not in ("auto", "flat", "ring"):
        raise ValueError(f"device.dispatch must be auto|flat|ring, got {dispatch!r}")
    if n_devices <= 1:
        if dispatch == "ring":
            raise ValueError("device.dispatch: ring requires a multi-device mesh")
        return "flat"
    if dispatch != "auto":
        return dispatch
    return "ring" if n >= RING_CROSSOVER_N else "flat"
