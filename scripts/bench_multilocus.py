"""Multi-locus sweep at catalog scale: the flagship beyond-reference claim
measured — per-locus marginal cost of ONE shared
cohort pass + multi-window counting + batched step 6, against the
reference's one-full-pipeline-per-locus design
(the reference's examples/1000G_example.sh:58,87).

    python scripts/bench_multilocus.py --out <dir> [--n 256] [--loci 600] \
        [--locus-bp 1000] [--cpu]

Fabricates ONE cohort whose alignments span `loci * locus_bp` of chr6,
writes a synthetic VNTR catalog tiling that span (Mukamel-2021 table
format, data/loci.py:load_vntr_catalog), then measures:

- t_single:   a full single-locus pipeline run (steps 1-6; what the
              reference pays PER LOCUS — fused ingest on, same code).
- t_sweep_1:  run_multi_locus over 1 locus (shared pass + overheads).
- t_sweep_L:  run_multi_locus over all L loci — one ingest pass counts
              every window (batch.cpp multi-window), one batched [N,N] @
              [N,L] dipCN device call, zero per-locus pipeline runs.

Derived: marginal_per_locus = (t_sweep_L - t_sweep_1) / (L - 1);
reference-design total = L * t_single; speedup = that / t_sweep_L.
Phasing is gated off (per-locus IBS regeneration is a separate, equally
per-locus cost in both designs — it would only dilute the comparison).
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import time
from pathlib import Path


def write_catalog(path: Path, chrom: str, start: int, n_loci: int, width: int):
    with open(path, "w") as f:
        f.write("CHR BP_START_HG38 BP_END_HG38 SAMTOOLS_START SAMTOOLS_END"
                " IBD2R GENE\n")
        for i in range(n_loci):
            lo = start + i * width
            hi = lo + width
            f.write(f"{chrom.removeprefix('chr')} {lo} {hi} {lo} {hi} 0.5"
                    f" G{i:04d}\n")
    return [f"G{i:04d}" for i in range(n_loci)]


def fresh_results(cfg, tag):
    out = Path(cfg["output_dir"]).parent / f"results_{tag}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    c = copy.deepcopy(cfg)
    c["output_dir"] = str(out)
    return c


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--loci", type=int, default=600)
    ap.add_argument("--locus-bp", type=int, default=1000)
    ap.add_argument("--mean-depth", type=float, default=3.0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (deterministic host run)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from grid_tpu.steps.multilocus import run_multi_locus
    from grid_tpu.pipeline import run_wgs_pipeline
    from grid_tpu.synth import make_synthetic_cohort_with_alignments

    out = Path(args.out)
    span = args.loci * args.locus_bp
    w0 = 160_400_000
    t0 = time.perf_counter()
    cohort = make_synthetic_cohort_with_alignments(
        out, n_samples=args.n, seed=29, mean_depth=args.mean_depth,
        chrom="chr6", window_start=w0, window_end=w0 + span,
    )
    t_fab = time.perf_counter() - t0
    print(f"fabricated {args.n} BAMs spanning {span / 1e3:.0f} kb in "
          f"{t_fab:.1f}s", flush=True)

    catalog = out / "catalog.txt"
    genes = write_catalog(catalog, "chr6", w0, args.loci, args.locus_bp)

    base = copy.deepcopy(cohort["config"])
    base["mosdepth"]["neighbors"]["num_neighbors"] = min(500, args.n - 1)
    base["compute_diploid_genotypes"]["n_nbr"] = min(300, args.n - 1)
    base["compute_haploid_genotypes"]["run"] = False
    base.setdefault("device", {})["fused"] = False

    report = {"n": args.n, "loci": args.loci, "locus_bp": args.locus_bp,
              "fabricate_s": round(t_fab, 1)}

    # --- reference design: ONE full pipeline for ONE locus ---------------
    single = fresh_results(base, "single")
    single["chrom"] = "chr6"
    single["start_bp"] = w0
    single["end_bp"] = w0 + args.locus_bp
    t0 = time.perf_counter()
    run_wgs_pipeline(console=None, config=single)
    report["t_single_full_s"] = round(time.perf_counter() - t0, 1)
    print(f"single-locus full pipeline: {report['t_single_full_s']}s",
          flush=True)

    # --- sweep with 1 locus: shared pass + constant overheads -------------
    sweep1 = fresh_results(base, "sweep1")
    t0 = time.perf_counter()
    run_multi_locus(sweep1, genes[:1], catalog=catalog)
    report["t_sweep_1_s"] = round(time.perf_counter() - t0, 1)
    print(f"sweep L=1: {report['t_sweep_1_s']}s", flush=True)

    # --- sweep with all L loci -------------------------------------------
    sweepL = fresh_results(base, "sweepL")
    t0 = time.perf_counter()
    run_multi_locus(sweepL, genes, catalog=catalog)
    report["t_sweep_L_s"] = round(time.perf_counter() - t0, 1)
    print(f"sweep L={args.loci}: {report['t_sweep_L_s']}s", flush=True)

    # sanity: every locus produced a dipCN table with rows
    n_ok = 0
    for g in genes:
        p = Path(sweepL["output_dir"]) / f"diploid_genotypes.{g}.tsv"
        if p.exists() and sum(1 for _ in open(p)) > 1:
            n_ok += 1
    report["loci_with_dipcn"] = n_ok

    marginal = (report["t_sweep_L_s"] - report["t_sweep_1_s"]) / max(
        args.loci - 1, 1)
    ref_total = args.loci * report["t_single_full_s"]
    report["marginal_per_locus_s"] = round(marginal, 3)
    report["reference_design_total_s"] = round(ref_total, 1)
    report["speedup_vs_per_locus_runs"] = round(
        ref_total / report["t_sweep_L_s"], 1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
