"""grid_tpu benchmark: cohort samples/s for normalize + kNN + dipCN.

Measures steps 4-6 of the fused cohort step on a 1000G-scale synthetic
cohort (N=2504 samples, R=2048 bins, k=500) on one GPU, against the
reference-equivalent CPU path (numpy normalize + brute-force numpy kNN +
per-sample dipCN loop, the algorithms the reference runs). With no GPU it
exits non-zero: it never measures a CPU run under a device metric's name.

Prints ONE JSON line:
    {"metric": ..., "value": samples_per_s, "unit": "samples/s",
     "vs_baseline": speedup_over_cpu_reference, "step_s": median_step_s,
     "compile_s": first_call_s, "device": {"platform", "kind", "count"},
     "peak_bytes_in_use": ..., "mfu": ..., "hbm_util": ...}

Each step is timed on the host clock around work that ends in
``jax.block_until_ready``; the median of ``--iters`` steps is reported.

Roofline model: the step's matmul work is the Gram (2*N^2*R FLOPs) at
Precision.HIGHEST, i.e. f32 outside the tensor cores; its device-memory
traffic is dominated by the selection/bisection passes over the resident
[N, N] d2 (~35 full-matrix reads) plus a few [N, R] z passes. ``mfu`` and
``hbm_util`` divide by the peaks of ``grid_tpu/utils/peaks.py``; a device
kind not in that table gives null.

Usage: python bench.py [--quick] [--n N] [--r R] [--k K] [--skip-baseline]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def make_matrix(n, r, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(25.0, 35.0, size=(n, 1))
    dose = np.ones((n, r))
    dose[:, : r // 8] = rng.normal(1.0, 0.15, size=(n, r // 8)).clip(0.3, 2.0)
    values = (base * dose * rng.normal(1.0, 0.03, size=(n, r))).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, size=n).astype(np.float64)
    return values * mask, mask, reads


def bench_device(values, mask, reads, k, n_nbr, iters=20):
    """(first-call seconds, median step seconds, outputs) of the fused step."""
    import jax
    import jax.numpy as jnp

    from grid_tpu.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu.models.cohort import CohortParams, make_cohort_step
    from grid_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()
    n = values.shape[0]
    params = CohortParams(
        num_neighbors=k, n_nbr=n_nbr, n_iters=0, quantize=False, row_block=512,
    )
    fn = jax.jit(make_cohort_step(params))
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 1)
    args = (
        jnp.asarray(values, dtype=jnp.float32),
        jnp.asarray(mask),
        jnp.asarray(reads, dtype=jnp.float32),
        jnp.ones((n,), dtype=bool),
        jnp.asarray(hi),
        jnp.asarray(hw),
        jnp.asarray(hv),
    )

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    steps = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        steps.append(time.perf_counter() - t0)
    return first, statistics.median(steps), out


def bench_cpu_reference(values, mask, reads, k, n_nbr):
    """Reference-equivalent CPU path: numpy NaN normalize + brute-force kNN +
    python dipCN loop (the algorithms of the reference steps)."""
    n = values.shape[0]
    mat = np.where(mask, values, np.nan)

    t0 = time.perf_counter()
    # normalize (grid/utils/normalize_mosdepth.py:419-476 math)
    row_means = np.nanmean(mat, axis=1)
    x = mat / np.where(row_means == 0, np.nan, row_means)[:, None]
    col_means = np.nanmean(x, axis=0)
    col_vars = np.nansum((x - col_means) ** 2, axis=0) / (n - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        var_ratio = np.where(col_means > 0, 100.0 * col_vars / col_means, np.nan)
    mu_pos = col_means > 0
    x[:, mu_pos] = (x[:, mu_pos] - col_means[mu_pos]) / np.sqrt(col_means[mu_pos])
    valid = var_ratio[~np.isnan(var_ratio)]
    scale = 1.0 / np.sqrt(np.median(valid) / 100.0) if valid.size else 1.0
    x *= scale
    # selection + clip/fill (steps 4b/5a)
    sorted_r = np.sort(valid)
    thr = sorted_r[min(int(0.1 * len(sorted_r)), len(sorted_r) - 1)]
    sel = np.where(~np.isnan(var_ratio) & (var_ratio > thr))[0]
    z = np.nan_to_num(np.clip(x[:, sel], -2.0, 2.0))
    # kNN (grid/utils/find_neighbors.py:179-227): brute force, self excluded
    sq = np.einsum("ij,ij->i", z, z)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (z @ z.T)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    # dipCN (grid/utils/compute_dipcn.py:62-87)
    scales = row_means
    out = np.zeros(n)
    for i in range(n):
        total, cnt = 0.0, 0
        for j in idx[i]:
            if cnt >= n_nbr:
                break
            total += reads[j] / scales[j]
            cnt += 1
        out[i] = (reads[i] / scales[i]) / (total / cnt)
    return time.perf_counter() - t0, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small shapes for smoke runs")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-baseline", action="store_true")
    args = ap.parse_args()

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py: no GPU (JAX's first device is {device.platform!r});"
              " it measures only on a GPU", file=sys.stderr)
        sys.exit(1)

    n = args.n or (512 if args.quick else 2504)
    r = args.r or (256 if args.quick else 2048)
    k = min(args.k or (50 if args.quick else 500), n - 1)
    n_nbr = min(300, n - 1)

    values, mask, reads = make_matrix(n, r)
    first, t_dev, out = bench_device(values, mask, reads, k, n_nbr, args.iters)
    vs = None
    if not args.skip_baseline:
        t_cpu, cpu_dip = bench_cpu_reference(values, mask, reads, k, n_nbr)
        err = float(np.nanmedian(np.abs(np.asarray(out.dipcn) - cpu_dip) / np.abs(cpu_dip)))
        if err > 1e-5:
            print(f"bench.py: device/cpu dipCN median rel err {err:.2e}", file=sys.stderr)
            sys.exit(1)
        vs = t_cpu / t_dev

    from grid_tpu.utils.peaks import peak_for

    mfu = hbm_util = None
    peak = peak_for(device.device_kind)
    if peak is not None:
        model_flops = 2.0 * n * n * r
        model_bytes = 35.0 * n * n * 4 + 6.0 * n * r * 4
        mfu = model_flops / t_dev / peak["f32_flops"]
        hbm_util = model_bytes / t_dev / peak["hbm_bytes_per_s"]

    print(json.dumps({
        "metric": f"normalize+kNN+dipCN cohort throughput (N={n}, R={r}, k={k})",
        "value": n / t_dev,
        "unit": "samples/s",
        "vs_baseline": vs,
        "step_s": t_dev,
        "compile_s": first,
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "peak_bytes_in_use": (device.memory_stats() or {}).get("peak_bytes_in_use"),
        "mfu": mfu,
        "hbm_util": hbm_util,
    }))


if __name__ == "__main__":
    main()
