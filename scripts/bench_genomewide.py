"""BASELINE config-2 chained measurement: 100 samples x 3M 1kb bins from
bed.gz ON DISK through host staging + device normalize, with the
host/device time split recorded.

    # host staging half (any platform):
    python scripts/bench_genomewide.py --out <dir>

    # + device half on the GPU:
    python scripts/bench_genomewide.py --out <dir> --device

Fabrication writes ONE genome-wide BGZF bed.gz (3M bins — the container
mosdepth itself emits) and
hardlinks it per sample — identical content does not cheapen the work
(every file is decompressed and parsed independently); fab time stands in
for mosdepth and is reported separately. The device phase times
normalize_cohort on on-device arrays of the staged shape, each call ended
by ``jax.block_until_ready``; the host-to-device copy is not included.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import time
from pathlib import Path

import numpy as np

N_SAMPLES = 100
N_BINS = 3_000_000
BIN = 1000


def fabricate(out: Path) -> float:
    beds = out / "mosdepth"
    beds.mkdir(parents=True, exist_ok=True)
    master = beds / "S000_region.regions.bed.gz"
    t0 = time.perf_counter()
    if not master.exists():
        # BGZF container, like mosdepth's own regions.bed.gz output (and
        # grid_tpu's built-in binner) — the representative on-disk form;
        # the scanner's libdeflate block path handles it
        from grid_tpu.io.bamlite import bgzf_compress

        rng = np.random.default_rng(7)
        depths = rng.normal(30.0, 3.0, N_BINS).clip(0.01)
        starts = np.arange(N_BINS, dtype=np.int64) * BIN
        step = 200_000
        from grid_tpu.io.bamlite import _BGZF_EOF

        with open(master, "wb") as f:
            for lo in range(0, N_BINS, step):
                hi = min(lo + step, N_BINS)
                text = "".join(
                    f"chr1\t{starts[i]}\t{starts[i] + BIN}\t{depths[i]:.2f}\n"
                    for i in range(lo, hi)
                ).encode()
                # strip the per-call EOF marker; ONE goes at the end
                f.write(bgzf_compress(text)[: -len(_BGZF_EOF)])
            f.write(_BGZF_EOF)
    for i in range(1, N_SAMPLES):
        link = beds / f"S{i:03d}_region.regions.bed.gz"
        if not link.exists():
            os.link(master, link)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", action="store_true",
                    help="also time device normalize (needs a GPU)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    out = Path(args.out)
    t_fab = fabricate(out)
    print(f"fabricated {N_SAMPLES} x {N_BINS}-bin bed.gz in {t_fab:.1f}s",
          flush=True)

    from grid_tpu.io.staging import stage_cohort

    samples = [f"S{i:03d}" for i in range(N_SAMPLES)]
    t0 = time.perf_counter()
    stage = stage_cohort(
        out / "mosdepth", samples, "chr1", 0, N_BINS * BIN, {},
        min_depth=0.01, max_depth=10_000.0, threads=args.threads,
    )
    t_stage = time.perf_counter() - t0
    n, r = stage.values.shape
    print(f"host staging: {t_stage:.1f}s -> [{n}, {r}] "
          f"({stage.values.nbytes / 1e9:.2f} GB float64)", flush=True)

    result = {
        "metric": "genome-wide staged ingest (100 x 3M bins from bed.gz)",
        "fab_s": round(t_fab, 2),
        "host_stage_s": round(t_stage, 2),
        "shape": [int(n), int(r)],
    }

    if args.device:
        import jax
        import jax.numpy as jnp

        from grid_tpu.ops.normalize import normalize_cohort

        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise SystemExit(f"--device measures only on a GPU, found {dev.platform!r}")
        print(f"device: {dev.device_kind}", flush=True)
        key = jax.random.PRNGKey(0)
        values = jax.device_put(
            jax.random.normal(key, (n, r), jnp.float32) * 3.0 + 30.0, dev)
        mask = jnp.ones((n, r), bool)
        fn = jax.jit(lambda v, m: normalize_cohort(v, m))
        jax.block_until_ready(fn(values, mask))  # compile
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(values, mask))
            best = min(best, time.perf_counter() - t0)
        print(f"device normalize: {best * 1e3:.3f} ms", flush=True)
        result["device_normalize_ms"] = best * 1e3
        result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                            "count": len(jax.devices())}

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
