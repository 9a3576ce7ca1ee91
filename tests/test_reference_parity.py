"""Bit-level parity: grid_tpu steps 4-7 vs the ACTUAL reference pipeline.

Runs the reference implementation from /root/reference (pure Python for
steps 4-7; pysam stubbed exactly as its own test suite does,
test/conftest.py:9-11) on a synthetic cohort, then runs grid_tpu on the same
inputs and compares the output files line by line.

Expected agreement:
- normalized matrix: identical to the %.2f/%.3f written precision;
- neighbors: identical neighbor SETS and distances (ordering may differ on
  exact ties);
- dipCN: identical within float tolerance;
- haploid: statistical tolerance (Jacobi vs Gauss-Seidel ordering), and
  bit-level in exact_phasing mode.
"""

import copy
import sys
from unittest import mock

import numpy as np
import pytest

REFERENCE = "/root/reference"


@pytest.fixture(scope="module")
def reference_modules():
    """Import the reference step modules with pysam stubbed."""
    if REFERENCE not in sys.path:
        sys.path.insert(0, REFERENCE)
    sys.modules.setdefault("pysam", mock.MagicMock())
    from grid.utils.normalize_mosdepth import normalize_mosdepth as ref_normalize
    from grid.utils.find_neighbors import find_neighbors as ref_neighbors
    from grid.utils.compute_dipcn import compute_diploid_genotypes as ref_dipcn
    from grid.utils.hi_inference import hi_inference as ref_hi

    return {
        "normalize": ref_normalize,
        "neighbors": ref_neighbors,
        "dipcn": ref_dipcn,
        "hi": ref_hi,
    }


@pytest.fixture(scope="module")
def dual_run(tmp_path_factory, reference_modules):
    """Run reference and grid_tpu pipelines on the same synthetic cohort."""
    from grid_tpu.synth import make_synthetic_cohort
    from grid_tpu.pipeline import run_wgs_pipeline

    base = tmp_path_factory.mktemp("parity")
    cohort = make_synthetic_cohort(base / "cohort", n_samples=16, seed=11, missing_frac=0.03)

    # reference run (its own output dir); its progress_bar needs the themed
    # console (styles "info"/"highlight"), same as its CLI provides
    from grid_tpu.utils.logging import make_console

    console = make_console()
    ref_cfg = copy.deepcopy(cohort["config"])
    ref_out = base / "ref_results"
    ref_out.mkdir()
    ref_cfg["output_dir"] = str(ref_out)
    # reference reads counts from its own output_dir; copy the counts file in
    (ref_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    for fn in ("normalize", "neighbors", "dipcn", "hi"):
        reference_modules[fn](ref_cfg, console)

    # grid_tpu run (exact phasing so step 7 matches bit-for-bit)
    our_cfg = copy.deepcopy(cohort["config"])
    our_out = base / "our_results"
    our_out.mkdir()
    our_cfg["output_dir"] = str(our_out)
    our_cfg["device"] = {"exact_phasing": True}
    (our_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    run_wgs_pipeline(console=None, config=our_cfg)

    return ref_out, our_out


def test_normalized_matrix_parity(dual_run):
    ref_out, our_out = dual_run
    import gzip

    ref_lines = gzip.open(ref_out / "mosdepth_results_normalized.tsv.gz", "rt").read().splitlines()
    our_lines = gzip.open(our_out / "mosdepth_results_normalized.tsv.gz", "rt").read().splitlines()
    assert len(ref_lines) == len(our_lines)
    # headers: N, Rwant then values at %.3f
    assert ref_lines[0] == our_lines[0]
    assert ref_lines[1] == our_lines[1]
    for rl, tl in zip(ref_lines[2:], our_lines[2:]):
        rp, tp = rl.split("\t"), tl.split("\t")
        assert rp[0] == tp[0]  # sample id
        assert rp[1] == tp[1]  # scale %.2f
        for rv, tv in zip(rp[2:], tp[2:]):
            if rv == "NA" or tv == "NA":
                assert rv == tv
            else:
                # %.2f differences of one ulp allowed at rounding boundaries
                assert abs(float(rv) - float(tv)) <= 0.01001, (rv, tv)


def test_neighbors_parity(dual_run):
    ref_out, our_out = dual_run
    from grid_tpu.io.formats import read_neighbors

    ref_nbrs, ref_scales = read_neighbors(ref_out / "neighbor_coverage.zMax2.0.tsv.gz")
    our_nbrs, our_scales = read_neighbors(our_out / "neighbor_coverage.zMax2.0.tsv.gz")
    assert set(ref_nbrs) == set(our_nbrs)
    assert ref_scales == our_scales
    for sid in ref_nbrs:
        ref_set = {n for n, _, _ in ref_nbrs[sid]}
        our_set = {n for n, _, _ in our_nbrs[sid]}
        assert ref_set == our_set, f"neighbor set differs for {sid}"
        ref_d = {n: d for n, _, d in ref_nbrs[sid]}
        our_d = {n: d for n, _, d in our_nbrs[sid]}
        for n in ref_d:
            assert abs(ref_d[n] - our_d[n]) <= 0.01001


def test_dipcn_parity(dual_run):
    ref_out, our_out = dual_run
    from grid_tpu.io.formats import read_dipcn

    ref_ids, ref_vals, _ = read_dipcn(ref_out / "diploid_genotypes.tsv")
    our_ids, our_vals, _ = read_dipcn(our_out / "diploid_genotypes.tsv")
    assert ref_ids == our_ids
    np.testing.assert_allclose(our_vals, ref_vals, rtol=1e-9)


def test_haploid_parity_exact_mode(dual_run):
    ref_out, our_out = dual_run
    ref_lines = (ref_out / "haploid_genotypes.tsv").read_text().splitlines()
    our_lines = (our_out / "haploid_genotypes.tsv").read_text().splitlines()
    # exact_phasing reproduces the reference's Gauss-Seidel ordering, so the
    # files must be IDENTICAL
    assert ref_lines == our_lines


def test_haploid_ibd_weighted_parity(tmp_path, reference_modules, dual_run):
    """IBD method (iLASH input) with Lorentzian weighting: grid_tpu's exact
    mode vs the reference, byte-for-byte, reusing the dipCN artifact."""
    import shutil

    ref_out, our_out = dual_run
    # both read the same dipCN file; give each its own output dir
    ref_dir = tmp_path / "ref"
    our_dir = tmp_path / "ours"
    ref_dir.mkdir()
    our_dir.mkdir()
    shutil.copy(ref_out / "diploid_genotypes.tsv", ref_dir / "diploid_genotypes.tsv")
    shutil.copy(ref_out / "diploid_genotypes.tsv", our_dir / "diploid_genotypes.tsv")

    # fabricate an iLASH file over the dipCN sample IDs
    from grid_tpu.io.formats import read_dipcn

    ids, _, _ = read_dipcn(ref_dir / "diploid_genotypes.tsv")
    ibd = tmp_path / "segments.tsv"
    with open(ibd, "w") as f:
        for i in range(len(ids)):
            j = (i + 1) % len(ids)
            k = (i + 3) % len(ids)
            f.write(
                f"{ids[i]}\t{ids[i]}_0\t{ids[j]}\t{ids[j]}_1\t6\t160500000\t160700000\t0\t0\t"
                f"{2.0 + 0.1 * i}\t0.93\n"
            )
            f.write(
                f"{ids[i]}\t{ids[i]}_1\t{ids[k]}\t{ids[k]}_0\t6\t160300000\t160550000\t0\t0\t"
                f"{1.1 + 0.05 * i}\t0.88\n"
            )
            # a segment failing the min_match filter
            f.write(
                f"{ids[i]}\t{ids[i]}_0\t{ids[k]}\t{ids[k]}_1\t6\t160500000\t160600000\t0\t0\t"
                f"5.0\t0.10\n"
            )

    base_cfg = {
        "output_file_type": "tsv",
        "start_bp": 160_605_062,
        "end_bp": 160_647_661,
        "compute_diploid_genotypes": {"output_file_prefix": "diploid_genotypes"},
        "compute_haploid_genotypes": {
            "run": True,
            "output_file_prefix": "haploid_genotypes",
            "method": "ibd",
            "ibd_output": str(ibd),
            "weighted": True,
            "weight_scale": 1_000_000,
            "min_length": 0.5,
            "min_match": 0.70,
            "min_neighbors": 1,
            "max_neighbors": 4,
            "n_iters": 60,
        },
    }

    import copy

    ref_cfg = copy.deepcopy(base_cfg)
    ref_cfg["output_dir"] = str(ref_dir)
    from grid_tpu.utils.logging import make_console

    reference_modules["hi"](ref_cfg, make_console())

    our_cfg = copy.deepcopy(base_cfg)
    our_cfg["output_dir"] = str(our_dir)
    our_cfg["device"] = {"exact_phasing": True}
    from grid_tpu.steps.haploid import hi_inference

    hi_inference(our_cfg, None)

    assert (
        (ref_dir / "haploid_genotypes.tsv").read_text()
        == (our_dir / "haploid_genotypes.tsv").read_text()
    )
