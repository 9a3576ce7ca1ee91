#!/usr/bin/env python3
"""Smoke run of the GRiD pipeline on a GPU: the quickest proof it starts.

    python chip_smoke.py          # one GPU: phases main, fused, bam, large_n
    python chip_smoke.py --four   # four GPUs: the sharded ring path only

Each phase drives the system through the entry points a user calls, on
cohorts fabricated from a seed at the width of the 1000 Genomes locus
deployment (N=2,504 samples, R=2,048 one-kb bins, k=500, n_nbr=300), and
checks what comes out against the float64 oracle in
``tests/reference_impl.py``:

- normalized matrix: within one %.2f ulp;
- neighbour sets: identical, except rows where the oracle's k-th and
  (k+1)-th distances differ by less than 1e-5 relative (counted, printed);
- dipCN: at most 1e-5 relative error on rows whose neighbour prefixes agree;
- haploid table: the Gauss-Seidel reference within the Jacobi-vs-Gauss-Seidel
  test tolerance (rtol 2e-4) plus one %.2f ulp.

Phases print what they ran, compile and steady-state wall-clock, the device
each step ran on and ``peak_bytes_in_use``. A failed phase makes the script
exit non-zero. With no GPU the script exits non-zero before fabricating
anything. The last line of a passing run is one JSON object naming the
device. This is a smoke record, not a benchmark.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The 1000 Genomes locus deployment (BASELINE.json config 4): the 43 one-kb
# bins of the LPA KIV-2 window plus flanks, to R=2,048 bins.
LOCUS_N = 2504
LOCUS_WINDOW = (160_605_000, 160_648_000)
LOCUS_R = 2048
K = 500
N_NBR = 300
HAP_K = 10
N_ITERS = 100

PLATFORM = "gpu"  # device.platform of every grid wgs run

TIE_RTOL = 1e-5  # oracle k-th vs (k+1)-th distance gap that counts as a tie
DIPCN_RTOL = 1e-5
HAP_RTOL = 2e-4  # tests/test_fuzz.py: Jacobi against Gauss-Seidel
ULP2 = 0.01 + 1e-9  # one %.2f ulp

COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
    "/jax/compilation_cache/cache_retrieval_time_sec",
)


class CheckFailed(AssertionError):
    """A phase's result disagrees with its reference."""


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


# ----------------------------------------------------------------- oracle ---


def knn_oracle_rows(zp, rows, k, col_ok=None):
    """Exact float64 neighbours of ``rows`` over all rows of ``zp``:
    squared Euclidean, self (and ~col_ok columns) excluded, ascending with
    index-order ties. Returns (d2 [len(rows), k+1], idx [len(rows), k+1])."""
    zp = np.asarray(zp, np.float64)
    sq = np.einsum("ij,ij->i", zp, zp)
    out_d, out_i = [], []
    for start in range(0, len(rows), 512):
        r = np.asarray(rows[start:start + 512])
        d2 = sq[r][:, None] + sq[None, :] - 2.0 * (zp[r] @ zp.T)
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(len(r)), r] = np.inf
        if col_ok is not None:
            d2[:, ~col_ok] = np.inf
        idx = np.argsort(d2, axis=1, kind="stable")[:, : k + 1]
        out_d.append(np.take_along_axis(d2, idx, axis=1))
        out_i.append(idx)
    return np.concatenate(out_d), np.concatenate(out_i)


def compare_neighbour_sets(dev_idx, ref_idx, ref_d2, k, rtol=TIE_RTOL):
    """Tie-aware comparison of the first ``k`` neighbours of each row.

    ``ref_idx``/``ref_d2`` hold the oracle's first k+1 neighbours,
    ascending. A row whose set differs from the oracle's is a tie when the
    oracle's k-th and (k+1)-th distances differ by less than ``rtol``
    relative; otherwise it is a mismatch.

    Returns (agree [rows] bool, n_ties, mismatched row positions)."""
    dev_idx = np.asarray(dev_idx)[:, :k]
    ref_idx = np.asarray(ref_idx)
    ref_d2 = np.asarray(ref_d2, np.float64)
    agree = np.array([
        set(dev_idx[i].tolist()) == set(ref_idx[i, :k].tolist())
        for i in range(dev_idx.shape[0])
    ])
    gap = ref_d2[:, k] - ref_d2[:, k - 1]
    tie = gap <= rtol * np.abs(ref_d2[:, k])
    ties = ~agree & tie
    mismatched = np.flatnonzero(~agree & ~tie)
    return agree, int(ties.sum()), mismatched


def prepare_oracle_z(z, used, zmax=2.0):
    """Reference step-5 prep: clip, NaN -> 0, keep the used columns."""
    return np.nan_to_num(np.clip(np.asarray(z, np.float64)[:, used], -zmax, zmax))


def used_regions(ratios, sigma2_max=1000.0):
    """Reference variance filter at frac_r=1: finite ratios <= sigma2_max."""
    finite = np.isfinite(ratios)
    if not finite.any():
        return np.arange(len(ratios))
    lo = np.min(ratios[finite])
    return np.flatnonzero(finite & (ratios >= lo) & (ratios <= sigma2_max))


# ------------------------------------------------------------ measurement ---


class CompileClock:
    """Sums JAX's compile-time events (trace, lowering, backend compile,
    persistent-cache retrieval) since construction."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.seconds += duration


class PlacementLog(logging.Handler):
    """Collects the placement each pipeline step logs (utils/device.py)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list[tuple[str, str]] = []
        logger = logging.getLogger("grid_tpu.utils.device")
        logger.setLevel(logging.INFO)
        logger.addHandler(self)

    def emit(self, record):
        self.records.append((record.funcName, record.args[0]))

    def take(self):
        out, self.records = self.records, []
        return out


def gpu_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def peak_bytes(devices=None):
    import jax

    out = []
    for d in devices or jax.devices()[:1]:
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out if len(out) > 1 else out[0]


def time_calls(fn, n_steady):
    """(first-call seconds, median steady-state seconds) of ``fn()``, each
    call ended by ``jax.block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = []
    for _ in range(n_steady):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    return first, statistics.median(steady), out


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------- cohorts ---


def fabricate_locus_cohort(root, n=LOCUS_N, r=LOCUS_R, seed=0):
    """The locus deployment on disk (bed.gz depths, counts, IBS neighbours)
    and its grid wgs config, trimmed to exactly ``r`` bins."""
    from grid_tpu.synth import make_synthetic_cohort

    w_bins = (LOCUS_WINDOW[1] - LOCUS_WINDOW[0]) // 1000
    flank = -(-(r - w_bins) // 2)
    cohort = make_synthetic_cohort(
        root, n_samples=n, window_start=LOCUS_WINDOW[0], window_end=LOCUS_WINDOW[1],
        flank_bins=flank, seed=seed, ibs_neighbors=HAP_K,
    )
    cfg = cohort["config"]
    # windows are closed intervals: end at the last kept bin's last base
    cfg["end_bp"] = cfg["start_bp"] + r * 1000 - 1
    cfg["mosdepth"]["neighbors"]["num_neighbors"] = min(K, n - 1)
    cfg["compute_diploid_genotypes"]["n_nbr"] = min(N_NBR, n - 1)
    cfg["compute_haploid_genotypes"]["max_neighbors"] = HAP_K
    cfg["compute_haploid_genotypes"]["n_iters"] = N_ITERS
    cfg["device"] = {"platform": PLATFORM}
    return cohort, cfg


def config_in(cfg, out_dir, **device):
    """A copy of ``cfg`` writing to ``out_dir`` (seeded with the counts)."""
    import copy

    cfg = copy.deepcopy(cfg)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = Path(cfg["output_dir"]) / f"{cfg['count_reads']['output_file_prefix']}.tsv"
    if counts.exists():
        shutil.copy(counts, out_dir / counts.name)
    cfg["output_dir"] = str(out_dir)
    cfg["device"].update(device)
    return cfg


def cohort_matrix(n, r, seed):
    """A depth matrix with a CN-like block, 2% missing cells, and reads."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(25.0, 35.0, size=(n, 1)).astype(np.float32)
    values = base * rng.normal(1.0, 0.03, size=(n, r)).astype(np.float32)
    block = r // 8
    values[:, :block] *= rng.normal(1.0, 0.15, size=(n, block)).clip(0.3, 2.0).astype(np.float32)
    np.clip(values, 0.5, None, out=values)
    mask = rng.random((n, r)) > 0.02
    values[~mask] = 0
    reads = rng.integers(500, 3000, size=n).astype(np.float32)
    return values, mask, reads


# ---------------------------------------------------------- table checks ---


def table_paths(cfg):
    from grid_tpu.io.formats import neighbors_filename

    out = Path(cfg["output_dir"])
    ft = cfg["output_file_type"]
    m = cfg["mosdepth"]
    return {
        "normalized": out / f"{m['normalize']['output_file_prefix']}.{ft}.gz",
        "neighbors": neighbors_filename(out, m["neighbors"]["output_file_prefix"],
                                        m["neighbors"]["zmax"], ft),
        "dipcn": out / f"{cfg['compute_diploid_genotypes']['output_file_prefix']}.{ft}",
        "haploid": out / f"{cfg['compute_haploid_genotypes']['output_file_prefix']}.{ft}",
    }


def data_rows(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def check_tables_written(cfg, n, phase):
    """Every expected table exists with n sample rows (the orchestrator
    logs a failed step and carries on, so its exit status proves nothing)."""
    paths = table_paths(cfg)
    for name, path in paths.items():
        check(path.exists(), f"{name} table missing: {path}")
    header_rows = {"normalized": 2, "neighbors": 0, "dipcn": 1, "haploid": 1}
    for name, path in paths.items():
        rows = len(data_rows(path)) - header_rows[name]
        check(rows == n, f"{name} table has {rows} rows, expected {n}")
    say(phase, f"tables written with {n} rows: {', '.join(paths)}")
    return paths


def read_haploid(path):
    rows = data_rows(path)[1:]
    ids = [r[0] for r in rows]
    vals = np.array([[float(v) for v in r[1:]] for r in rows])
    return ids, vals


def check_locus_tables(cfg, phase):
    """Check the four tables of a grid wgs run against the float64 oracle.

    Returns the per-table arrays for cross-phase comparison."""
    sys.path.insert(0, str(REPO / "tests"))
    from reference_impl import dipcn_np, normalize_matrix_np, select_high_variance_np

    from grid_tpu.io.bed import load_repeat_mask
    from grid_tpu.io.formats import read_counts_tsv, read_dipcn, read_neighbors
    from grid_tpu.io.formats import read_normalized_data, read_samples
    from grid_tpu.io.hap_neighbors import load_ibs_neighbors
    from grid_tpu.io.staging import stage_cohort
    from grid_tpu.ops.phasing import compute_imputed_host, phase_gauss_seidel_host

    paths = table_paths(cfg)
    ncfg = cfg["mosdepth"]["normalize"]
    kcfg = cfg["mosdepth"]["neighbors"]
    k = kcfg["num_neighbors"]
    n_nbr = cfg["compute_diploid_genotypes"]["n_nbr"]

    # step 4: normalized matrix against the oracle on the staged depths
    stage = stage_cohort(
        cfg["mosdepth"]["work_dir"], read_samples(cfg["samples_file"]), cfg["chrom"],
        cfg["start_bp"], cfg["end_bp"], load_repeat_mask(ncfg["repeat_mask_file"]),
        ncfg["min_depth"], ncfg["max_depth"], cfg["threads"],
    )
    mat = np.where(stage.mask, stage.values, np.nan)
    z_ref, ratio_ref, *_ = normalize_matrix_np(mat)
    sel = select_high_variance_np(ratio_ref, ncfg["top_frac"])
    ids, ratios, z_dev, scales = read_normalized_data(paths["normalized"])
    check(ids == list(stage.sample_ids), "normalized rows are not the staged samples")
    check(z_dev.shape == (len(ids), len(sel)),
          f"normalized matrix {z_dev.shape}, oracle selects {len(sel)} columns")
    want = np.round(z_ref[:, sel], 2)
    check(np.array_equal(np.isnan(z_dev), np.isnan(want)), "normalized NaN pattern differs")
    diff = np.nan_to_num(np.abs(z_dev - want))
    check(diff.max() <= ULP2, f"normalized matrix off by {diff.max():.4f} > one %.2f ulp")
    say(phase, f"normalized {z_dev.shape[0]}x{stage.values.shape[1]} -> {len(sel)} selected"
               f" columns; max |dev - oracle| {diff.max():.4f},"
               f" {int((diff > 1e-9).sum())} cells one ulp off")

    # step 5: neighbour sets from the WRITTEN matrix, as the step reads it
    zp = prepare_oracle_z(z_dev, used_regions(ratios, kcfg["sigma2_max"]), kcfg["zmax"])
    ref_d2, ref_idx = knn_oracle_rows(zp, np.arange(len(ids)), k)
    pos = {sid: i for i, sid in enumerate(ids)}
    nbrs, _ = read_neighbors(paths["neighbors"])
    dev_idx = np.array([[pos[nid] for nid, _, _ in nbrs[sid]] for sid in ids])
    check(dev_idx.shape == (len(ids), k), f"neighbour lists {dev_idx.shape}")
    agree, ties, bad = compare_neighbour_sets(dev_idx, ref_idx, ref_d2, k)
    check(bad.size == 0, f"{bad.size} rows' neighbour sets differ beyond ties: {bad[:5]}")
    pre_agree, pre_ties, pre_bad = compare_neighbour_sets(
        dev_idx[:, :n_nbr], ref_idx[:, : n_nbr + 1], ref_d2[:, : n_nbr + 1], n_nbr)
    check(pre_bad.size == 0, f"{pre_bad.size} rows' first-{n_nbr} sets differ beyond ties")
    say(phase, f"neighbours k={k}: {int(agree.sum())}/{len(ids)} rows identical,"
               f" {ties} tie rows; first {n_nbr}: {pre_ties} tie rows")

    # step 6: dipCN against the oracle on rows whose averaged prefix agrees
    reads = read_counts_tsv(Path(cfg["output_dir"]) / f"{cfg['count_reads']['output_file_prefix']}.tsv")
    oracle_nbrs = {sid: [(ids[j], scales[ids[j]]) for j in ref_idx[i, :k]]
                   for i, sid in enumerate(ids)}
    dip_ref = dipcn_np(reads, scales, oracle_nbrs, n_nbr)
    dip_ids, dip_vals, _ = read_dipcn(paths["dipcn"])
    dip_dev = dict(zip(dip_ids, dip_vals))
    check(set(dip_dev) == set(dip_ref), "dipCN sample set differs from the oracle's")
    rows = [sid for i, sid in enumerate(ids) if pre_agree[i]]
    rel = np.array([abs(dip_dev[s] - dip_ref[s]) / abs(dip_ref[s]) for s in rows])
    check(rel.max() <= DIPCN_RTOL, f"dipCN rel err {rel.max():.2e} > {DIPCN_RTOL}")
    say(phase, f"dipCN: max rel err {rel.max():.2e} over {len(rows)} rows")

    # step 7: haploid table against Gauss-Seidel from the written dipCN
    hcfg = cfg["compute_haploid_genotypes"]
    dip_ids, irrs, id_to_ind = read_dipcn(paths["dipcn"])
    hap_nbrs = load_ibs_neighbors(hcfg["ibs_output"], id_to_ind, hcfg["max_neighbors"])
    hap_ref, mean_ref, _ = phase_gauss_seidel_host(irrs, hap_nbrs, hcfg["min_neighbors"],
                                                   hcfg["n_iters"])
    imp = [compute_imputed_host(i, hap_ref, hap_nbrs, mean_ref) for i in range(len(irrs))]
    ref = np.column_stack([irrs, hap_ref[0::2], hap_ref[1::2],
                           [a for a, _ in imp], [b for _, b in imp]])
    hap_ids, hap_dev = read_haploid(paths["haploid"])
    check(hap_ids == dip_ids, "haploid rows differ from the dipCN rows")
    check(np.array_equal(np.isnan(hap_dev), np.isnan(ref)), "haploid NaN pattern differs")
    err = np.nan_to_num(np.abs(hap_dev - np.round(ref, 2)) - HAP_RTOL * np.abs(ref))
    check(err.max() <= ULP2, f"haploid table off by {err.max():.4f} beyond tolerance")
    say(phase, f"haploid: {len(hap_ids)} rows within rtol {HAP_RTOL} + one %.2f ulp"
               f" of Gauss-Seidel")
    return {"z": z_dev, "ids": ids, "scales": scales, "nbr_idx": dev_idx, "dipcn": dip_dev,
            "haploid": hap_dev}


def run_pipeline(cfg, clock, placements, phase):
    """grid wgs in-process: returns (wall, compile seconds, step timings)."""
    from grid_tpu.pipeline import run_wgs_pipeline

    c0 = clock.seconds
    t0 = time.perf_counter()
    timings = run_wgs_pipeline(console=None, config=cfg)
    wall = time.perf_counter() - t0
    compile_s = clock.seconds - c0
    steps = placements.take()
    for func, platform in steps:
        say(phase, f"step {func} ran on {platform}")
    check(steps, "no step reported a device placement")
    off = [f for f, p in steps if p != PLATFORM]
    check(not off, f"steps not on {PLATFORM}: {off}")
    say(phase, f"grid wgs wall {wall:.2f}s: compile {compile_s:.2f}s,"
               f" steady-state {wall - compile_s:.2f}s;"
               f" steps {json.dumps({k: round(v, 3) for k, v in timings.items()})}")
    return timings


# ----------------------------------------------------------------- phases ---


class Smoke:
    """Shared state of one smoke run: work directory, clocks, cohorts."""

    def __init__(self, work):
        self.work = Path(work)
        self.clock = CompileClock()
        self.placements = PlacementLog()
        self.locus = None
        self.main_tables = None

    def locus_cohort(self, n=LOCUS_N, r=LOCUS_R):
        if self.locus is None:
            t0 = time.perf_counter()
            self.locus = fabricate_locus_cohort(self.work / "locus", n, r)
            say("setup", f"fabricated the {n}-sample locus cohort in"
                         f" {time.perf_counter() - t0:.1f}s")
        return self.locus

    def phase_main(self, n=LOCUS_N, r=LOCUS_R):
        say("main", f"grid wgs steps 4-7, sequential, N={n} R={r} k={min(K, n - 1)}"
                    f" n_nbr={min(N_NBR, n - 1)} IBS K={HAP_K} n_iters={N_ITERS},"
                    f" device.platform=gpu")
        _, cfg = self.locus_cohort(n, r)
        cfg = config_in(cfg, self.work / "out_main")
        run_pipeline(cfg, self.clock, self.placements, "main")
        check_tables_written(cfg, n, "main")
        self.main_tables = check_locus_tables(cfg, "main")
        say("main", f"peak_bytes_in_use {peak_bytes()}")

    def phase_fused(self, n=LOCUS_N, r=LOCUS_R, n_steady=10):
        from grid_tpu.io.bed import load_repeat_mask
        from grid_tpu.io.formats import read_counts_tsv, read_samples
        from grid_tpu.io.hap_neighbors import pad_hap_neighbors
        from grid_tpu.models.cohort import CohortParams, cohort_step
        from grid_tpu.ops.knn import d2_matrix, prepare_z
        from grid_tpu.ops.select import dipcn_from_distances
        from grid_tpu.steps.normalize import _stage

        import jax
        import jax.numpy as jnp

        say("fused", f"grid wgs steps 4-7 with device.fused=true on the main cohort (N={n})")
        _, cfg = self.locus_cohort(n, r)
        cfg = config_in(cfg, self.work / "out_fused", fused=True)
        run_pipeline(cfg, self.clock, self.placements, "fused")
        check_tables_written(cfg, n, "fused")
        tables = check_locus_tables(cfg, "fused")
        if self.main_tables is not None:
            main = self.main_tables
            dz = np.nan_to_num(np.abs(tables["z"] - main["z"]))
            check(dz.max() <= ULP2, f"fused normalized differs from main by {dz.max():.4f}")
            ids = main["ids"]
            ds = max(abs(tables["scales"][i] - main["scales"][i]) for i in ids)
            check(ds <= ULP2, f"fused scales differ from main by {ds:.4f}")
            # a one-ulp flip in a written scale shifts dipCN by ~0.01/scale,
            # and a flip in z can move a near-tie neighbour: dipCN is
            # compared where both runs averaged the same neighbours with
            # the same scales
            flipped = {i for i in ids if tables["scales"][i] != main["scales"][i]}
            same = []
            for row, sid in enumerate(ids):
                nb = set(main["nbr_idx"][row, :N_NBR].tolist())
                if (nb == set(tables["nbr_idx"][row, :N_NBR].tolist())
                        and sid not in flipped and not {ids[j] for j in nb} & flipped):
                    same.append(sid)
            rel = max(abs(tables["dipcn"][s] - main["dipcn"][s]) / abs(main["dipcn"][s])
                      for s in same)
            check(rel <= DIPCN_RTOL, f"fused dipCN differs from main by {rel:.2e}")
            dh = np.nan_to_num(np.abs(tables["haploid"] - main["haploid"]))
            check(dh.max() <= ULP2, f"fused haploid differs from main by {dh.max():.4f}")
            say("fused", f"equal to main to the %.2f rounding: max |dz| {dz.max():.4f},"
                         f" max |dscale| {ds:.4f} ({len(flipped)} flipped); dipCN rel"
                         f" {rel:.2e} over the {len(same)}/{n} rows averaging the same"
                         f" neighbours and scales; max |dhap| {dh.max():.4f}")

        # the device program alone, as the fused path calls it
        ncfg = cfg["mosdepth"]["normalize"]
        stage = _stage(cfg, read_samples(cfg["samples_file"]), cfg["chrom"], cfg["start_bp"],
                       cfg["end_bp"], load_repeat_mask(ncfg["repeat_mask_file"]),
                       ncfg["min_depth"], ncfg["max_depth"], cfg["threads"], None)
        counts = read_counts_tsv(Path(cfg["output_dir"]) / "read_counts.tsv")
        reads = np.array([counts[s] for s in stage.sample_ids], np.float32)
        hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], HAP_K)
        args = [jnp.asarray(a) for a in (stage.values.astype(np.float32), stage.mask, reads,
                                          np.ones(n, bool), hi, hw, hv)]
        params = CohortParams(num_neighbors=min(K, n - 1), n_nbr=min(N_NBR, n - 1), n_iters=0)
        first, steady, out = time_calls(lambda: cohort_step(*args, params=params), n_steady)
        say("fused", f"cohort_step device time at N={n} R={stage.values.shape[1]}:"
                     f" first call (compile+run) {first:.3f}s, steady-state median of"
                     f" {n_steady} {steady * 1e3:.3f} ms on {out.dipcn.devices()}")

        # the dipCN layer alone: its passes over the [N, N] d2
        zp = prepare_z(out.z, out.z_mask, params.zmax, region_mask=out.region_used)
        d2 = jax.block_until_ready(d2_matrix(zp, row_valid=jnp.any(out.z_mask, axis=1)))
        w = args[2] / out.scales
        ok = args[3]
        _, t_dip, _ = time_calls(
            lambda: dipcn_from_distances(d2, w, w, ok, ok, k=params.num_neighbors,
                                         n_nbr=params.n_nbr), n_steady)
        passes = 2 * (31 + int(n - 1).bit_length()) + 6
        model_bytes = passes * d2.size * d2.dtype.itemsize
        say("fused", f"dipCN layer (dipcn_from_distances) at N={n}: {t_dip * 1e3:.3f} ms;"
                     f" d2 {d2.nbytes / 1e6:.1f} MB, ~{passes} passes ="
                     f" {model_bytes / 1e9:.2f} GB model traffic ->"
                     f" {model_bytes / t_dip / 1e12:.2f} TB/s effective")
        say("fused", f"peak_bytes_in_use {peak_bytes()}")

    def phase_bam(self, n=LOCUS_N):
        from grid_tpu import native
        from grid_tpu.io.formats import read_normalized_data
        from grid_tpu.synth import (
            make_synthetic_cohort_with_alignments,
            make_synthetic_phased_panel,
        )

        say("bam", f"grid wgs steps 1-7 from fabricated BAM alignments, N={n}:"
                   f" BAI, counts, depth and IBS on the host, steps 4-7 on the device")
        root = self.work / "bam"
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort_with_alignments(root, n_samples=n, seed=9,
                                                       mean_depth=4.0)
        hap_cn = cohort["hap_cn"].reshape(-1)
        groups = np.searchsorted(np.quantile(hap_cn, [0.25, 0.5, 0.75]), hap_cn)
        panel = make_synthetic_phased_panel(root / "panel", n_samples=n, n_sites=400,
                                            seed=9, hap_groups=groups)
        say("bam", f"fabricated BAM cohort + phased panel in {time.perf_counter() - t0:.1f}s")
        cfg = cohort["config"]
        cfg["mosdepth"]["neighbors"]["num_neighbors"] = min(K, n - 1)
        cfg["compute_diploid_genotypes"]["n_nbr"] = min(N_NBR, n - 1)
        cfg["compute_ibs"] = {
            "run": True, "vcf": str(panel["vcf"]),
            "focal_bp": (cfg["start_bp"] + cfg["end_bp"]) // 2,
            "num_neighbors": 20, "output_file_prefix": "ibs_neighbors",
        }
        cfg["compute_haploid_genotypes"]["ibs_output"] = None
        cfg["device"] = {"platform": PLATFORM}
        try:
            native.lib()
            ingest = "native C++ library"
        except (OSError, subprocess.CalledProcessError) as e:
            ingest = f"Python fallback ({e})"
        timings = run_pipeline(cfg, self.clock, self.placements, "bam")
        say("bam", f"ingest served by the {ingest};"
                   f" one-pass ingest ran: {'fused_ingest_2_3' in timings}")
        paths = check_tables_written(cfg, n, "bam")
        _, _, z, _ = read_normalized_data(paths["normalized"])
        check(np.isfinite(z).any(axis=1).all(), "a normalized row has no finite value")
        for name in ("dipcn", "haploid"):
            vals = np.array([[float(v) for v in r[1:]] for r in data_rows(paths[name])[1:]])
            check(np.isfinite(vals[:, 0]).all(), f"{name} table has non-finite values")
        say("bam", "tables finite (planted copy number not checked: ROADMAP B6)")
        say("bam", f"peak_bytes_in_use {peak_bytes()}")

    def phase_large_n(self, n=32768, r=1024, n_rows=256, n_steady=2, d2_budget_bytes=None):
        from grid_tpu.io.hap_neighbors import pad_hap_neighbors
        from grid_tpu.models.cohort import CohortParams, cohort_step

        import jax.numpy as jnp

        params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=0, quantize=False)
        if d2_budget_bytes is not None:
            params = params._replace(d2_budget_bytes=d2_budget_bytes)
        check(n * n * 4 > params.d2_budget_bytes, "large_n must exceed the d2 budget")
        say("large_n", f"cohort_step directly at N={n} R={r} k={K} n_nbr={N_NBR}: the"
                       f" row-panel path (knn_squared two-stage col_block +"
                       f" dipcn_from_distances_panels)")
        values, mask, reads = cohort_matrix(n, r, seed=1)
        hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 1)
        args = [jnp.asarray(a) for a in (values, mask, reads, np.ones(n, bool), hi, hw, hv)]
        first, steady, out = time_calls(lambda: cohort_step(*args, params=params), n_steady)
        say("large_n", f"first call (compile+run) {first:.2f}s, steady-state median of"
                       f" {n_steady} {steady:.3f}s on {out.dipcn.devices()}")
        rows = np.sort(np.random.default_rng(2).choice(n, size=min(n_rows, n), replace=False))
        check_rows_against_oracle(oracle_geometry(values, mask, params), reads, rows,
                                  np.asarray(out.nbr_idx)[rows], np.asarray(out.dipcn)[rows],
                                  params, "large_n")
        say("large_n", f"peak_bytes_in_use {peak_bytes()}")

    def phase_four(self, n=100_000, r=2048, n_rows=256, locus_n=LOCUS_N, locus_r=LOCUS_R):
        import jax
        import jax.numpy as jnp

        from grid_tpu.io.hap_neighbors import pad_hap_neighbors
        from grid_tpu.models.cohort import CohortParams, cohort_step
        from grid_tpu.parallel import cohort_mesh, sharded_cohort_step

        devices = jax.devices()
        check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
        mesh = cohort_mesh(4)
        params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=0, quantize=False)
        say("four", f"sharded_cohort_step on a 4-device cohort mesh (psum stats +"
                    f" ring-ppermute kNN) at N={n} R={r} k={K}, against one device's"
                    f" panel path on the same matrix")
        values, mask, reads = cohort_matrix(n, r, seed=3)
        hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 1)
        hap = [jnp.asarray(a) for a in (hi, hw, hv)]
        c0 = self.clock.seconds
        first, steady, ring = time_calls(
            lambda: sharded_cohort_step(mesh, values, mask, reads, np.ones(n, bool), *hap,
                                        params), 1)
        say("four", f"ring: first call {first:.2f}s (compile {self.clock.seconds - c0:.2f}s),"
                    f" steady-state {steady:.3f}s; outputs on {ring.dipcn.sharding.device_set}")
        ring_idx = np.asarray(ring.nbr_idx)[:n]
        ring_dip = np.asarray(ring.dipcn)[:n]
        del ring
        with jax.default_device(devices[0]):
            args = [jnp.asarray(a) for a in (values, mask, reads, np.ones(n, bool))]
            first, steady, one = time_calls(lambda: cohort_step(*args, *hap, params=params), 1)
        say("four", f"one device: first call {first:.2f}s, steady-state {steady:.3f}s")
        one_idx = np.asarray(one.nbr_idx)
        one_dip = np.asarray(one.dipcn)
        del one, args

        # ring against one device: every row where the two disagree (a
        # neighbour set, or dipCN beyond 1e-5) is judged by the oracle on
        # both sides, with the tie rule. The one-device path bisects its own
        # panel distances for dipCN, so at an n_nbr-boundary near-tie its
        # averaged set can differ from its written list.
        def same_sets(width):
            return (np.sort(ring_idx[:, :width], axis=1)
                    == np.sort(one_idx[:, :width], axis=1)).all(axis=1)

        same, same_pre = same_sets(K), same_sets(N_NBR)
        rel = np.abs(ring_dip - one_dip) / np.abs(one_dip)
        dip_apart = same_pre & ~(rel <= DIPCN_RTOL)
        diff_rows = np.flatnonzero(~same | ~same_pre | dip_apart)
        say("four", f"ring vs one device: neighbour sets identical on {int(same.sum())}/{n}"
                    f" rows; dipCN within {DIPCN_RTOL} on"
                    f" {int(same_pre.sum() - dip_apart.sum())}/{int(same_pre.sum())} rows"
                    f" with the same first {N_NBR}; {diff_rows.size} rows that disagree"
                    f" go to the oracle")
        geometry = oracle_geometry(values, mask, params)
        if diff_rows.size:
            for side, idx, dip in (("ring", ring_idx, ring_dip), ("one device", one_idx, one_dip)):
                check_rows_against_oracle(geometry, reads, diff_rows, idx[diff_rows],
                                          dip[diff_rows], params, f"four, {side}")
        rows = np.sort(np.random.default_rng(4).choice(n, size=min(n_rows, n), replace=False))
        check_rows_against_oracle(geometry, reads, rows, ring_idx[rows], ring_dip[rows],
                                  params, "four")
        say("four", f"peak_bytes_in_use per device {peak_bytes(devices[:4])}")
        del values, mask, geometry

        say("four", f"grid wgs steps 4-7 fused with device.mesh_shape=[4],"
                    f" dispatch=ring at N={locus_n}")
        _, cfg = self.locus_cohort(locus_n, locus_r)
        cfg = config_in(cfg, self.work / "out_four", fused=True, mesh_shape=[4],
                        dispatch="ring")
        run_pipeline(cfg, self.clock, self.placements, "four")
        check_tables_written(cfg, locus_n, "four")
        check_locus_tables(cfg, "four")


def oracle_geometry(values, mask, params):
    """Float64 oracle of steps 4-5 on a depth matrix (quantize=False):
    (prepared z [N, R_use], raw row means [N], rows with any valid cell)."""
    sys.path.insert(0, str(REPO / "tests"))
    from reference_impl import normalize_matrix_np, select_high_variance_np

    mat = np.where(mask, values, np.nan).astype(np.float64)
    z, ratio, _, _, row_means, _ = normalize_matrix_np(mat)
    del mat
    sel = np.zeros(len(ratio), bool)
    sel[select_high_variance_np(ratio, params.top_frac)] = True
    used = np.flatnonzero(sel)[used_regions(ratio[sel], params.sigma2_max)]
    return prepare_oracle_z(z, used, params.zmax), row_means, mask.any(axis=1)


def check_rows_against_oracle(geometry, reads, rows, dev_idx, dev_dip, params, phase):
    """Neighbour sets (tie rule) and dipCN (1e-5) of ``rows`` against the
    float64 oracle computed for those rows only.

    dipCN is compared on rows whose first n_nbr agree with the oracle and
    are not an oracle near-tie at the n_nbr boundary: there a path that
    bisects distances for dipCN (the row-panel path) may average the other
    side of the tie than its written list holds."""
    zp, row_means, ok = geometry
    k, n_nbr = params.num_neighbors, params.n_nbr
    ref_d2, ref_idx = knn_oracle_rows(zp, rows, k, col_ok=ok)
    agree, ties, bad = compare_neighbour_sets(dev_idx, ref_idx, ref_d2, k)
    check(bad.size == 0, f"{bad.size} rows' neighbour sets differ beyond ties")
    pre_agree, pre_ties, pre_bad = compare_neighbour_sets(
        dev_idx[:, :n_nbr], ref_idx[:, : n_nbr + 1], ref_d2[:, : n_nbr + 1], n_nbr)
    check(pre_bad.size == 0, f"{pre_bad.size} rows' first-{n_nbr} sets differ beyond ties")
    pre_tie = ref_d2[:, n_nbr] - ref_d2[:, n_nbr - 1] <= TIE_RTOL * np.abs(ref_d2[:, n_nbr])
    w = np.asarray(reads, np.float64) / row_means
    dip_ref = w[rows] / w[ref_idx[:, :n_nbr]].mean(axis=1)
    rel = np.abs(np.asarray(dev_dip, np.float64) - dip_ref) / np.abs(dip_ref)
    rel = rel[pre_agree & ~pre_tie]
    check(rel.size == 0 or rel.max() <= DIPCN_RTOL, f"dipCN rel err {rel.max():.2e}")
    say(phase, f"oracle on {len(rows)} rows: {int(agree.sum())} sets identical, {ties} tie"
               f" rows (first {n_nbr}: {pre_ties}); dipCN max rel"
               f" {rel.max() if rel.size else 0:.2e} over {rel.size} rows"
               f" ({int(pre_tie.sum())} n_nbr-boundary ties set aside)")


# ------------------------------------------------------------------- main ---


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded ring path and its comparison")
    args = ap.parse_args(argv)

    if not (REPO / "grid_tpu" / "__init__.py").exists():
        print(f"chip_smoke.py: no grid_tpu package next to {__file__};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        devices, why = [], str(e)
    else:
        why = f"JAX's first device is {devices[0].platform!r}"
    if not devices or devices[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU: {why}; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    print(f"gpu: {gpu_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}", flush=True)

    from grid_tpu import native
    from grid_tpu.utils.device import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    t0 = time.perf_counter()
    try:
        native.build()
        print(f"native library built in {time.perf_counter() - t0:.1f}s", flush=True)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"native library build failed ({e}); the Python fallbacks serve", flush=True)

    failed = []
    (REPO / ".smoke").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="run-", dir=REPO / ".smoke") as work:
        smoke = Smoke(work)
        phases = (["four"] if args.four else ["main", "fused", "bam", "large_n"])
        for name in phases:
            t0 = time.perf_counter()
            try:
                getattr(smoke, f"phase_{name}")()
                say(name, f"ok in {time.perf_counter() - t0:.1f}s")
            except Exception:
                traceback.print_exc()
                say(name, f"FAILED after {time.perf_counter() - t0:.1f}s")
                failed.append(name)

    print(f"gpu: {gpu_line()}", flush=True)
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
