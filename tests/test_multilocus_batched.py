"""Batched multi-locus execution vs the per-locus loop.

The sweep's batched form — per-locus counts as byproducts of the one
ingest scan, step 6 for all loci as one [N, N] @ [N, L] device call — must
reproduce the per-locus loop's artifacts: counts byte-identical, dipCN equal
up to summation order, haploid tables equal at their written precision.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import pytest


@pytest.fixture(scope="module")
def catalog3(tmp_path_factory):
    p = tmp_path_factory.mktemp("cat") / "catalog.txt"
    p.write_text(
        "CHR\tBP_START_HG38\tBP_END_HG38\tSAMTOOLS_START_HG38\t"
        "SAMTOOLS_END_HG38\tIBD2R\tGENE\n"
        "6\t160605000\t160610000\t160605000\t160610000\t0.9\tGENEA\n"
        "6\t160607000\t160612000\t160607000\t160612000\t0.8\tGENEB\n"
        "6\t160610000\t160615000\t160610000\t160615000\t0.7\tGENEC\n"
    )
    return p


def _sweep(tmp_path, catalog, batched, fused_ingest="auto", seed=21):
    from grid_tpu.steps.multilocus import run_multi_locus
    from grid_tpu.synth import make_synthetic_cohort_with_alignments

    cohort = make_synthetic_cohort_with_alignments(
        tmp_path, n_samples=8, seed=seed
    )
    cfg = copy.deepcopy(cohort["config"])
    cfg.setdefault("device", {})["fused_ingest"] = fused_ingest
    run_multi_locus(
        cfg, ["GENEA", "GENEB", "GENEC"], console=None, catalog=catalog,
        batched=batched,
    )
    res = Path(cohort["results_dir"])
    out = {}
    for gene in ("GENEA", "GENEB", "GENEC"):
        counts = sorted((res / f"read_counts.{gene}.tsv").read_bytes().splitlines())
        dip = {
            l.split("\t")[0]: float(l.split("\t")[1])
            for l in (res / f"diploid_genotypes.{gene}.tsv").read_text().splitlines()[1:]
        }
        hap_path = res / f"haploid_genotypes.{gene}.tsv"
        hap = hap_path.read_text() if hap_path.exists() else None
        out[gene] = (counts, dip, hap)
    return out


def test_batched_sweep_matches_loop(tmp_path, catalog3):
    batched = _sweep(tmp_path / "batched", catalog3, batched=True)
    loop = _sweep(tmp_path / "loop", catalog3, batched=False)
    for gene in ("GENEA", "GENEB", "GENEC"):
        b_counts, b_dip, b_hap = batched[gene]
        l_counts, l_dip, l_hap = loop[gene]
        assert b_counts == l_counts, f"{gene}: counts differ"
        assert set(b_dip) == set(l_dip), f"{gene}: dipCN sample sets differ"
        ids = sorted(b_dip)
        np.testing.assert_allclose(
            [b_dip[i] for i in ids], [l_dip[i] for i in ids], rtol=1e-9,
            err_msg=f"{gene}: dipCN values",
        )
        assert (b_hap is None) == (l_hap is None)
        if b_hap is not None:
            bl, ll = b_hap.splitlines(), l_hap.splitlines()
            assert bl[0] == ll[0]
            for brow, lrow in zip(sorted(bl[1:]), sorted(ll[1:])):
                bs, ls = brow.split("\t"), lrow.split("\t")
                assert bs[0] == ls[0]
                np.testing.assert_allclose(
                    [float(x) for x in bs[1:]], [float(x) for x in ls[1:]],
                    atol=0.011, err_msg=f"{gene}: haploid row {bs[0]}",
                )
        # the loop's dipCN values should not be trivially constant
        assert np.std([l_dip[i] for i in ids]) > 0


def test_batched_sweep_without_fused_ingest(tmp_path, catalog3):
    """With the one-pass ingest forced off, per-locus counting falls back to
    the classic step (phase 2a) and batched dipCN still matches the loop."""
    batched = _sweep(
        tmp_path / "b", catalog3, batched=True, fused_ingest="false", seed=4
    )
    loop = _sweep(
        tmp_path / "l", catalog3, batched=False, fused_ingest="false", seed=4
    )
    for gene in ("GENEA", "GENEB", "GENEC"):
        assert batched[gene][0] == loop[gene][0]
        b_dip, l_dip = batched[gene][1], loop[gene][1]
        assert set(b_dip) == set(l_dip)
        ids = sorted(b_dip)
        np.testing.assert_allclose(
            [b_dip[i] for i in ids], [l_dip[i] for i in ids], rtol=1e-9
        )


def test_multiwindow_counts_match_classic_step(tmp_path, catalog3):
    """Counts files produced by the shared scan (multi-window native ingest)
    must be byte-identical to the classic per-locus count_reads step."""
    try:
        from grid_tpu import native

        native.lib()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"native build failed: {e}")
    fused = _sweep(tmp_path / "f", catalog3, batched=True, fused_ingest="true", seed=9)
    classic = _sweep(tmp_path / "c", catalog3, batched=True, fused_ingest="false", seed=9)
    for gene in ("GENEA", "GENEB", "GENEC"):
        assert fused[gene][0] == classic[gene][0], f"{gene}: counts differ"
