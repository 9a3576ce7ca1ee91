"""CPU-mesh shape-scaling sweep for the parallel layer:
ring kNN and psum-normalize vs the single-device ops at growing N, plus the
GSPMD-vs-explicit strategy comparison, on the 8-virtual-device CPU mesh.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_mesh_sweep.py --ns 8192,32768,65536 --r 256 --k 64

Emits one JSON line per shape. This is a regression canary for collective
layouts — wall-clock on shared CI cores is noisy, but order-of-magnitude
regressions (accidental all-gather of z, a [B, N] merge) show immediately.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def timeit(fn, iters=3):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", default="8192,32768,65536")
    ap.add_argument("--r", type=int, default=256)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from grid_tpu.ops.knn import knn_squared
    from grid_tpu.ops.normalize import normalize_cohort
    from grid_tpu.parallel.mesh import cohort_mesh, cohort_sharding
    from grid_tpu.parallel.pknn import ring_knn
    from grid_tpu.parallel.pstats import normalize_cohort_sharded

    mesh = cohort_mesh()
    n_dev = int(mesh.devices.size)
    print(f"devices: {n_dev}", flush=True)

    for n in (int(s) for s in args.ns.split(",")):
        rng = np.random.default_rng(0)
        z = rng.normal(0, 1, (n, args.r)).astype(np.float32)
        vals = rng.gamma(30, 1, (n, args.r)).astype(np.float32)
        m = rng.random((n, args.r)) > 0.02

        rep = {"n": n, "r": args.r, "k": args.k, "devices": n_dev}

        zj = jnp.asarray(z)
        rep["knn_flat_s"] = round(timeit(lambda: knn_squared(zj, args.k),
                                         args.iters), 3)
        s2 = cohort_sharding(mesh, 2)
        zs = jax.device_put(z, s2)
        rep["knn_ring_s"] = round(timeit(lambda: ring_knn(zs, args.k, mesh),
                                         args.iters), 3)

        vj = jnp.asarray(vals)
        mj = jnp.asarray(m)
        norm1 = jax.jit(lambda v, mm: normalize_cohort(v, mm).z)
        rep["norm_flat_s"] = round(timeit(lambda: norm1(vj, mj), args.iters), 4)
        vs = jax.device_put(vals, s2)
        ms = jax.device_put(m, s2)
        rep["norm_psum_s"] = round(
            timeit(lambda: normalize_cohort_sharded(vs, ms, mesh).z, args.iters), 4
        )

        # set agreement ring vs flat (exactness canary at scale)
        _, fi = knn_squared(zj, args.k)
        _, ri = ring_knn(zs, args.k, mesh)
        fi, ri = np.asarray(fi), np.asarray(ri)
        agree = np.mean([
            len(set(fi[i]) & set(ri[i])) / args.k
            for i in range(0, n, max(n // 256, 1))
        ])
        rep["set_agreement"] = round(float(agree), 5)
        print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
