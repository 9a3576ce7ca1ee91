"""Fused steps 4-7 vs the file-by-file pipeline on the same cohort."""

import copy

import numpy as np
import pytest

from grid_tpu.io.formats import read_dipcn, read_neighbors, read_normalized_data
from grid_tpu.pipeline import run_wgs_pipeline
from grid_tpu.synth import make_synthetic_cohort


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("fused")
    cohort = make_synthetic_cohort(base / "cohort", n_samples=15, seed=21, missing_frac=0.02)

    file_cfg = copy.deepcopy(cohort["config"])
    file_out = base / "file_results"
    file_out.mkdir()
    file_cfg["output_dir"] = str(file_out)
    (file_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    t_file = run_wgs_pipeline(console=None, config=file_cfg)

    fused_cfg = copy.deepcopy(cohort["config"])
    fused_out = base / "fused_results"
    fused_out.mkdir()
    fused_cfg["output_dir"] = str(fused_out)
    fused_cfg["device"] = {"fused": True}
    (fused_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    t_fused = run_wgs_pipeline(console=None, config=fused_cfg)

    return cohort, file_out, fused_out, t_file, t_fused


def test_fused_mode_engaged(both_runs):
    _, _, _, t_file, t_fused = both_runs
    assert "normalize" in t_file and "fused_steps_4_7" in t_fused
    assert "normalize" not in t_fused


def test_fused_artifacts_exist(both_runs):
    _, _, fused_out, _, _ = both_runs
    for name in (
        "mosdepth_results_normalized.tsv.gz",
        "neighbor_coverage.zMax2.0.tsv.gz",
        "diploid_genotypes.tsv",
        "haploid_genotypes.tsv",
    ):
        assert (fused_out / name).exists(), name


def test_fused_normalized_matches_file_mode(both_runs):
    _, file_out, fused_out, _, _ = both_runs
    f_ids, f_ratio, f_mat, f_scales = read_normalized_data(
        file_out / "mosdepth_results_normalized.tsv.gz"
    )
    g_ids, g_ratio, g_mat, g_scales = read_normalized_data(
        fused_out / "mosdepth_results_normalized.tsv.gz"
    )
    assert f_ids == g_ids
    np.testing.assert_allclose(g_ratio, f_ratio, rtol=1e-9)
    np.testing.assert_array_equal(np.isnan(g_mat), np.isnan(f_mat))
    np.testing.assert_allclose(
        g_mat[~np.isnan(g_mat)], f_mat[~np.isnan(f_mat)], atol=0.01001
    )
    assert f_scales == g_scales


def test_fused_neighbors_match(both_runs):
    _, file_out, fused_out, _, _ = both_runs
    f_nbrs, _ = read_neighbors(file_out / "neighbor_coverage.zMax2.0.tsv.gz")
    g_nbrs, _ = read_neighbors(fused_out / "neighbor_coverage.zMax2.0.tsv.gz")
    assert set(f_nbrs) == set(g_nbrs)
    for sid in f_nbrs:
        assert {n for n, _, _ in f_nbrs[sid]} == {n for n, _, _ in g_nbrs[sid]}


def test_fused_dipcn_matches(both_runs):
    _, file_out, fused_out, _, _ = both_runs
    f_ids, f_vals, _ = read_dipcn(file_out / "diploid_genotypes.tsv")
    g_ids, g_vals, _ = read_dipcn(fused_out / "diploid_genotypes.tsv")
    assert f_ids == g_ids
    np.testing.assert_allclose(g_vals, f_vals, rtol=1e-6)


def test_fused_haploid_close_to_file_mode(both_runs):
    # same Jacobi phasing in both paths -> outputs agree (both via %.2f)
    _, file_out, fused_out, _, _ = both_runs
    f_lines = (file_out / "haploid_genotypes.tsv").read_text().splitlines()
    g_lines = (fused_out / "haploid_genotypes.tsv").read_text().splitlines()
    assert len(f_lines) == len(g_lines)
    for fl, gl in zip(f_lines[1:], g_lines[1:]):
        fp, gp = fl.split("\t"), gl.split("\t")
        assert fp[0] == gp[0]
        for a, b in zip(fp[1:], gp[1:]):
            if a == "nan" or b == "nan":
                assert a == b
            else:
                assert abs(float(a) - float(b)) <= 0.01001


def test_fused_failure_falls_back_to_sequential(tmp_path):
    """When fused staging fails (e.g. counts file missing at fused-stage
    time but present later... simulate via bad work_dir), the pipeline must
    fall back to the sequential steps rather than skipping 4-7."""
    import copy

    cohort = make_synthetic_cohort(tmp_path / "c", n_samples=8, seed=4)
    cfg = copy.deepcopy(cohort["config"])
    out = tmp_path / "out"
    out.mkdir()
    cfg["output_dir"] = str(out)
    cfg["device"] = {"fused": True}
    # fused stage reads counts from output_dir; do NOT copy the counts file:
    # the fused path raises, the sequential path then runs steps 4+5 (which
    # don't need counts) and fails only 6/7 per-step (reference semantics).
    timings = run_wgs_pipeline(console=None, config=cfg)
    assert "fused_steps_4_7" not in timings or "normalize" in timings
    assert (out / "mosdepth_results_normalized.tsv.gz").exists()
    assert (out / "neighbor_coverage.zMax2.0.tsv.gz").exists()


def test_fused_mesh_mode_matches_single_device(tmp_path):
    """device.mesh_shape shards the fused step over the virtual 8-CPU mesh;
    outputs must match the single-device fused run."""
    import copy

    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    cohort = make_synthetic_cohort(tmp_path / "c", n_samples=13, seed=9)

    single_cfg = copy.deepcopy(cohort["config"])
    s_out = tmp_path / "single"
    s_out.mkdir()
    single_cfg["output_dir"] = str(s_out)
    single_cfg["device"] = {"fused": True}
    (s_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    run_wgs_pipeline(console=None, config=single_cfg)

    mesh_cfg = copy.deepcopy(cohort["config"])
    m_out = tmp_path / "mesh"
    m_out.mkdir()
    mesh_cfg["output_dir"] = str(m_out)
    mesh_cfg["device"] = {"fused": True, "mesh_shape": [8]}
    (m_out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    timings = run_wgs_pipeline(console=None, config=mesh_cfg)
    assert "fused_steps_4_7" in timings

    s_dip = (s_out / "diploid_genotypes.tsv").read_text().splitlines()
    m_dip = (m_out / "diploid_genotypes.tsv").read_text().splitlines()
    assert len(s_dip) == len(m_dip)
    for a, b in zip(s_dip[1:], m_dip[1:]):
        pa, pb = a.split("\t"), b.split("\t")
        assert pa[0] == pb[0]
        assert abs(float(pa[1]) - float(pb[1])) < 1e-6


def test_device_dtype_knob(tmp_path):
    """device.dtype: float32 runs the fused step in f32 (results still within
    %.2f write precision of the f64 run)."""
    import copy

    cohort = make_synthetic_cohort(tmp_path / "c", n_samples=10, seed=14)
    outs = {}
    for name, dtype in [("auto", None), ("f32", "float32")]:
        cfg = copy.deepcopy(cohort["config"])
        out = tmp_path / name
        out.mkdir()
        cfg["output_dir"] = str(out)
        cfg["device"] = {"fused": True}
        if dtype:
            cfg["device"]["dtype"] = dtype
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
        run_wgs_pipeline(console=None, config=cfg)
        outs[name] = (out / "diploid_genotypes.tsv").read_text().splitlines()
    assert len(outs["auto"]) == len(outs["f32"])
    for a, b in zip(outs["auto"][1:], outs["f32"][1:]):
        va, vb = float(a.split("\t")[1]), float(b.split("\t")[1])
        assert abs(va - vb) < 1e-4


def test_approx_max_k_recall_is_exact():
    """The d2-resident neighbor selection must pass recall_target=1.0:
    JAX's 0.95 default lets a backend lower approx_max_k to a genuinely
    approximate selection (CPU and GPU lower it to an exact top-k, so a
    numeric test cannot catch a
    regression) — and approximate neighbor lists break the written-artifact
    parity contract. Pin it by source inspection."""
    import inspect

    import grid_tpu.models.cohort as cohort_mod

    src = inspect.getsource(cohort_mod)
    assert "approx_max_k" in src
    for i, line in enumerate(src.splitlines()):
        if "approx_max_k(" in line:
            window = "\n".join(src.splitlines()[i : i + 3])
            assert "recall_target=1.0" in window, (
                "approx_max_k without recall_target=1.0 in models/cohort.py"
            )
