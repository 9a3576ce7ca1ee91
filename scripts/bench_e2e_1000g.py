"""One end-to-end 1000G-scale wall-clock: fabricate a 2,504-sample BAM
cohort, run the FULL pipeline (steps 1-7 including ingest) once, and
report per-step wall-clock.

    python scripts/bench_e2e_1000g.py --out <dir> [--n 2504] [--fused] \
        [--platform cpu|gpu]

Fabrication time is reported separately — it stands in for the download,
not for pipeline work. Steps 1-3 are host-bound (native BAM readers);
steps 4-7 run on the accelerator (fused) or per-step.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=2504)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--mean-depth", type=float, default=4.0)
    ap.add_argument("--file-type", choices=["bam", "cram"], default="bam",
                    help="cohort alignment format (cram exercises the"
                         " self-contained CRAM ingest end to end)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="device.platform for every step (cpu = host-only"
                         " run; gpu = every step on the GPU or fail)")
    args = ap.parse_args()

    import yaml

    from grid_tpu.pipeline import run_wgs_pipeline
    from grid_tpu.synth import (
        make_synthetic_cohort_with_alignments,
        make_synthetic_phased_panel,
    )

    out = Path(args.out)
    t0 = time.perf_counter()
    cohort = make_synthetic_cohort_with_alignments(
        out, n_samples=args.n, seed=9, mean_depth=args.mean_depth,
        file_type=args.file_type,
    )
    import numpy as np

    hap_cn = cohort["hap_cn"].reshape(-1)
    groups = np.searchsorted(np.quantile(hap_cn, [0.25, 0.5, 0.75]), hap_cn)
    panel = make_synthetic_phased_panel(out / "panel", n_samples=args.n,
                                        n_sites=400, seed=9, hap_groups=groups)
    t_fab = time.perf_counter() - t0
    # fresh pipeline outputs: fabrication leaves a counts file + state from
    # any previous run in results/
    for stale in (out / "results").glob("*"):
        if stale.name != "truth_hap_cn.tsv" and not stale.name.startswith("read_counts"):
            stale.unlink()
    print(f"fabricated {args.n}-sample {args.file_type.upper()} cohort + phased panel in {t_fab:.1f}s",
          flush=True)

    cfg = yaml.safe_load(open(cohort["config_file"]))
    cfg["threads"] = args.threads
    # BASELINE parameters (the synth default k=N-1 suits tiny cohorts only)
    cfg["mosdepth"]["neighbors"]["num_neighbors"] = min(500, args.n - 1)
    cfg["compute_diploid_genotypes"]["n_nbr"] = min(300, args.n - 1)
    cfg["compute_ibs"] = {
        "run": True,
        "vcf": str(panel["vcf"]),
        "focal_bp": (cfg["start_bp"] + cfg["end_bp"]) // 2,
        "num_neighbors": 20,
        "output_file_prefix": "ibs_neighbors",
    }
    cfg["compute_haploid_genotypes"]["ibs_output"] = None
    if args.fused:
        cfg.setdefault("device", {})["fused"] = True
    if args.platform:
        cfg.setdefault("device", {})["platform"] = args.platform
        if args.platform == "cpu":
            import jax

            jax.config.update("jax_platforms", "cpu")

    t0 = time.perf_counter()
    run_wgs_pipeline(console=None, config=cfg)
    t_total = time.perf_counter() - t0

    timings = json.loads((Path(cfg["output_dir"]) / "step_timings.json").read_text())
    report = {"n": args.n, "file_type": args.file_type,
              "platform": args.platform or "default",
              "fused": bool(args.fused), "fabricate_s": round(t_fab, 1),
              "pipeline_total_s": round(t_total, 1),
              "steps_s": {k: round(v, 2) for k, v in timings.items()}}
    print(json.dumps(report), flush=True)

    hap = Path(cfg["output_dir"]) / (
        cfg["compute_haploid_genotypes"]["output_file_prefix"] + ".tsv"
    )
    n_rows = sum(1 for _ in open(hap)) - 1 if hap.exists() else 0
    print(f"haploid table rows: {n_rows}", flush=True)


if __name__ == "__main__":
    main()
