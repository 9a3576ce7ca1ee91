#!/usr/bin/env bash
# End-to-end demo on a fabricated cohort — no external data, no network,
# no external tools (no samtools/mosdepth/pysam/computeIBSpbwt).
#
# Fabricates an alignment cohort with planted copy-number structure plus a
# phased haplotype panel, then runs the full pipeline: built-in ingestion
# (BAM or from-scratch CRAM) -> device cohort math (steps 4-6) -> native PBWT
# IBS neighbors -> haploid phasing; prints the haploid copy-number table
# next to the planted truth.
#
# Usage: synthetic_cohort.sh [OUT_DIR] [N_SAMPLES] [bam|cram]
set -euo pipefail

OUT="${1:-/tmp/grid_tpu_demo}"
N="${2:-16}"
FMT="${3:-bam}"

REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

echo ">> Fabricating a $N-sample cohort with $FMT alignments at $OUT"
python - <<PY
import yaml
from grid_tpu.synth import (
    make_synthetic_cohort_with_alignments,
    make_synthetic_phased_panel,
)

c = make_synthetic_cohort_with_alignments("$OUT", n_samples=$N, seed=1,
                                          file_type="$FMT")
# a phased panel with matching sample IDs whose haplotype sharing follows
# the planted CNs (shared haplotype => shared repeat allele) — the
# pipeline's compute_ibs step derives the neighbors from it natively
import numpy as np

hap_cn = c["hap_cn"].reshape(-1)
groups = np.searchsorted(np.quantile(hap_cn, [0.25, 0.5, 0.75]), hap_cn)
p = make_synthetic_phased_panel("$OUT/panel", n_samples=$N, n_sites=200,
                                seed=1, hap_groups=groups)
cfg = yaml.safe_load(open(c["config_file"]))
cfg["compute_ibs"] = {
    "run": True,
    "vcf": str(p["vcf"]),
    "focal_bp": p["focal_bp"],
    "genetic_map": str(p["genetic_map"]),
    "num_neighbors": min($N - 1, 8),
}
cfg["compute_haploid_genotypes"]["ibs_output"] = None
yaml.safe_dump(cfg, open(c["config_file"], "w"), sort_keys=False)
print("config:", c["config_file"])
PY

echo ">> Running the pipeline"
python -m grid_tpu.cli wgs "$OUT/config.yaml"

echo ">> Estimated haploid copy numbers:"
head -n $((N + 1)) "$OUT/results/haploid_genotypes.tsv"

echo ">> Planted truth:"
head -n $((N + 1)) "$OUT/results/truth_hap_cn.tsv"

echo ">> Per-step timings:"
cat "$OUT/results/step_timings.json"
