"""Biobank-scale (BASELINE config 5) demonstration: bounded-memory
shard-direct staging + sharded normalize + ring kNN at 100k samples.

Synthetic per-sample depth rows are REGENERATED from a seed on each pass
(O(1) host memory per sample, like re-reading a bed.gz), staged straight to
the 8-virtual-device CPU mesh via stage_cohort_sharded, then the
explicit-collective cohort step runs end to end. Records wall-clock per
phase and peak RSS.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_biobank.py --n 100000 --r 2048 --k 500

Beyond ~150k rows on a 2-core host, a single ring hop's compute exceeds
the CPU backend's stuck-collective terminate timeout (the process aborts
inside CollectivePermute with a "Check failure" after the rendezvous
waits too long — an artifact of 2 cores emulating 8 devices, not of the
design). Raise it for capacity probes:

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \
        --xla_cpu_collective_call_terminate_timeout_seconds=3600" \
        JAX_PLATFORMS=cpu python scripts/bench_biobank.py --n 200000 ...

    # one GPU, kNN-only scaling probe:
    python scripts/bench_biobank.py --single --n 131072 --r 2048 --k 500
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np


def peak_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def synthetic_source(n, r, bin_size=1000, seed=0):
    """Fresh-iterator factory: per-sample rows regenerated from the seed —
    host cost O(R) per sample, never O(N*R)."""

    def factory():
        def it():
            starts = np.arange(r, dtype=np.int64) * bin_size
            ends = starts + bin_size
            for i in range(n):
                rng = np.random.default_rng(seed + i)
                base = rng.uniform(25.0, 35.0)
                d = rng.normal(base, 1.0, r).clip(1.0, None)
                yield f"S{i:06d}", [("chr1", starts, ends, d)]
        return it()

    return factory


def run_mesh(args):
    import jax
    import jax.numpy as jnp

    from grid_tpu.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu.io.staging import stage_cohort_sharded
    from grid_tpu.models.cohort import CohortParams
    from grid_tpu.parallel.mesh import cohort_mesh, cohort_sharding
    from grid_tpu.parallel.pcohort import sharded_cohort_step

    mesh = cohort_mesh(args.devices)
    print(f"mesh: {mesh.devices.size} devices", flush=True)
    report = {"n": args.n, "r": args.r, "k": args.k,
              "devices": int(mesh.devices.size)}

    t0 = time.perf_counter()
    stage = stage_cohort_sharded(
        synthetic_source(args.n, args.r), mesh, min_depth=1, max_depth=1000
    )
    jax.block_until_ready(stage.values)
    report["stage_s"] = round(time.perf_counter() - t0, 2)
    report["stage_peak_rss_gb"] = round(peak_rss_gb(), 2)
    print(f"staged {stage.values.shape} in {report['stage_s']}s, "
          f"peak RSS {report['stage_peak_rss_gb']} GB", flush=True)

    n, n_pad = stage.n, stage.values.shape[0]
    rng = np.random.default_rng(7)
    s1 = cohort_sharding(mesh, 1)
    reads = jax.device_put(
        np.pad(rng.integers(500, 3000, n).astype(np.float32), (0, n_pad - n)), s1
    )
    rv = jax.device_put(np.ones(n_pad, bool), s1)
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n_pad)], 1)
    params = CohortParams(num_neighbors=args.k, n_nbr=min(300, args.k),
                          n_iters=0, quantize=False)

    def run_step(payload_ring):
        t0 = time.perf_counter()
        out = sharded_cohort_step(
            mesh, stage.values, stage.mask, reads, rv,
            jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), params,
            row_valid=stage.row_valid, payload_ring=payload_ring,
        )
        jax.block_until_ready(out.dipcn)
        return time.perf_counter() - t0, out

    forms = ([True, False] if args.compare else [True])
    best = {}
    out = None
    for rnd in range(args.rounds):
        for payload_ring in forms:
            name = "ring" if payload_ring else "gather"
            dt, out = run_step(payload_ring)
            best[name] = min(best.get(name, float("inf")), dt)
            print(f"round {rnd} {name}: {dt:.1f}s", flush=True)
    report["step_s"] = round(best["ring"], 2)
    if args.compare:
        report["step_gather_s"] = round(best["gather"], 2)
    report["peak_rss_gb"] = round(peak_rss_gb(), 2)
    report["samples_per_s"] = round(n / report["step_s"], 1)
    dip = np.asarray(out.dipcn)[:n]
    report["dipcn_finite_frac"] = round(float(np.isfinite(dip).mean()), 4)
    print(json.dumps(report), flush=True)


def run_single(args):
    import jax
    import jax.numpy as jnp

    from grid_tpu.ops.knn import knn_squared
    from grid_tpu.utils.device import enable_compilation_cache
    from grid_tpu.utils.peaks import peak_for

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"--single measures only on a GPU, found {device.platform!r}")
    enable_compilation_cache()
    report = {"mode": "single", "n": args.n, "r": args.r, "k": args.k,
              "device": {"platform": device.platform, "kind": device.device_kind,
                         "count": len(jax.devices())}}
    rng = np.random.default_rng(0)
    # build on device in column chunks to keep host allocation < 1 shard
    cols = []
    chunk = max(args.r // 8, 1)
    for c0 in range(0, args.r, chunk):
        cols.append(jnp.asarray(
            rng.normal(0, 1, (args.n, min(chunk, args.r - c0))).astype(np.float32)
        ))
    z = jnp.concatenate(cols, axis=1)
    jax.block_until_ready(z)

    t0 = time.perf_counter()
    d, i = jax.block_until_ready(knn_squared(z, args.k, row_block=512))
    report["knn_cold_s"] = time.perf_counter() - t0

    # steady state: each call ends in block_until_ready; best of the
    # rounds (the cold number above includes compile)
    best = float("inf")
    for _ in range(args.rounds * max(1, args.iters)):
        t0 = time.perf_counter()
        d, i = jax.block_until_ready(knn_squared(z, args.k, row_block=512))
        best = min(best, time.perf_counter() - t0)
    report["knn_s"] = best
    # roofline against the peak table (Gram at Precision.HIGHEST: f32
    # outside the tensor cores). Traffic model for the blocked two-stage
    # selection: the [R, N] z.T panel streams once per row block (Gram),
    # the [B, N] d2 panel is written once and read once by selection,
    # outputs are [N, k] x2.
    n_, r_, k_ = args.n, args.r, args.k
    n_blocks = -(-n_ // 512)
    model_flops = 2.0 * n_ * n_ * r_
    model_bytes = (n_blocks * n_ * r_ * 4.0) + 2.0 * n_ * n_ * 4.0 + n_ * k_ * 8.0
    peak = peak_for(device.device_kind)
    report["knn_mfu"] = None if peak is None else model_flops / best / peak["f32_flops"]
    report["knn_hbm_util"] = (
        None if peak is None else model_bytes / best / peak["hbm_bytes_per_s"]
    )
    report["knn_samples_per_s"] = n_ / best

    # step-6 beyond the d2 budget: the r3 gather-free row-panel form vs the
    # [N, k] gather formulation it replaces (same process, same data)
    from grid_tpu.ops.dipcn import compute_dipcn
    from grid_tpu.ops.select import dipcn_from_distances_panels

    w = jnp.asarray(rng.uniform(0.5, 2.0, args.n).astype(np.float32))
    ok = jnp.ones(args.n, bool)
    t0 = time.perf_counter()
    dip_p, _ = jax.block_until_ready(dipcn_from_distances_panels(
        z, w, w, ok, ok, k=args.k, n_nbr=min(300, args.k), row_block=512
    ))
    report["dipcn_panels_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dip_g, _ = jax.block_until_ready(compute_dipcn(w, ok, w[i], ok[i], n_nbr=min(300, args.k)))
    report["dipcn_gather_s"] = time.perf_counter() - t0
    report["dipcn_agree"] = round(
        float(np.nanmax(np.abs(np.asarray(dip_p) - np.asarray(dip_g)))), 8
    )
    report["peak_rss_gb"] = round(peak_rss_gb(), 2)
    report["peak_bytes_in_use"] = (device.memory_stats() or {}).get("peak_bytes_in_use")
    print(json.dumps(report), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--r", type=int, default=2048)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=1,
                    help="interleaved timing rounds; min reported")
    ap.add_argument("--iters", type=int, default=3,
                    help="--single mode: timed calls per round")
    ap.add_argument("--compare", action="store_true",
                    help="time the payload ring AND the r2 replicated-"
                         "gather form, interleaved")
    ap.add_argument("--single", action="store_true",
                    help="one-GPU kNN probe instead of the CPU mesh run")
    args = ap.parse_args()
    if args.single:
        run_single(args)
    else:
        run_mesh(args)


if __name__ == "__main__":
    main()
