"""Multi-locus sweep: one staged cohort, many VNTR windows.

The reference is strictly single-locus — a whole pipeline run per VNTR
(examples/1000G_example.sh resolves ONE gene's coordinates from the
734-region catalog, :58,87). grid_tpu's extension: the expensive
cohort-level work (genome-wide binned coverage -> normalize -> kNN) is
LOCUS-INDEPENDENT, so it runs once; only the cheap window-indexed pieces
(read counting in the locus window, dipCN, phasing) repeat per locus.

Per-locus artifacts get a ``.{GENE}`` prefix suffix, so a sweep over the
bundled catalog produces one counts/dipCN/haploid table per gene next to the
shared normalized-matrix and neighbors artifacts.
"""

from __future__ import annotations

import copy
from pathlib import Path

from grid_tpu.data.loci import Locus, resolve_locus
from grid_tpu.utils.logging import log

# steps whose artifacts depend on the locus window and therefore re-run per
# locus with suffixed output prefixes
_PER_LOCUS_PREFIXES = (
    ("count_reads", "output_file_prefix"),
    ("compute_diploid_genotypes", "output_file_prefix"),
    ("compute_haploid_genotypes", "output_file_prefix"),
    ("compute_ibs", "output_file_prefix"),
)


def locus_config(config: dict, locus: Locus) -> dict:
    """A deep-copied config re-targeted at ``locus``: window coordinates
    swapped in, per-locus output prefixes suffixed ``.{gene}``, and the IBS
    focal position re-centered on the window midpoint."""
    cfg = copy.deepcopy(config)
    cfg["chrom"] = locus.chrom
    cfg["start_bp"] = locus.start
    cfg["end_bp"] = locus.end
    tag = locus.gene.split(",")[0] or f"{locus.chrom}_{locus.start}"
    for section, key in _PER_LOCUS_PREFIXES:
        sec = cfg.get(section)
        if isinstance(sec, dict) and sec.get(key):
            sec[key] = f"{sec[key]}.{tag}"
    ibs = cfg.get("compute_ibs")
    if isinstance(ibs, dict) and ibs.get("run") is True:
        ibs["focal_bp"] = (locus.start + locus.end) // 2
        hap = cfg.get("compute_haploid_genotypes")
        if isinstance(hap, dict) and hap.get("ibs_output"):
            # regenerating IBS per locus: a single shared IBS file cannot
            # serve every locus; the per-locus path is derived from the
            # (suffixed) compute_ibs prefix by the orchestrator
            hap["ibs_output"] = None
    return cfg


def _counts_file(cfg) -> Path:
    out_type = cfg.get("output_file_type", "tsv")
    prefix = cfg.get("count_reads", {}).get("output_file_prefix")
    return Path(f"{cfg.get('output_dir', '.')}/{prefix}.{out_type}")


def _dipcn_file(cfg) -> Path:
    out_type = cfg.get("output_file_type", "tsv")
    prefix = cfg.get("compute_diploid_genotypes", {}).get("output_file_prefix")
    return Path(f"{cfg.get('output_dir', '.')}/{prefix}.{out_type}")


def run_batched_dipcn(shared_config, locus_cfgs, console=None):
    """Step 6 for MANY loci in one (or few) device calls.

    The distance geometry (the written normalized matrix -> prepare_z ->
    pairwise d2) is locus-independent; per locus only the read-count
    weights differ, so the L masked neighbor sums collapse into one
    [N, N] @ [N, L] matmul (ops/select.py:dipcn_from_distances_multi).
    Loci are grouped by their column-usability pattern (which samples have
    a count) — with the one-pass multi-window ingest that is ONE group.

    Per-locus outputs match the sequential step
    (steps/dipcn.py:compute_diploid_genotypes, itself the reference's
    grid/utils/compute_dipcn.py:62-87) up to f64 summation order.

    Args:
        shared_config: the base config (normalize/neighbors sections locate
            the shared artifacts).
        locus_cfgs: {gene: per-locus config} — counts/dipCN prefixes
            already .GENE-suffixed (locus_config).

    Returns {gene: dipcn_path} for the loci written.
    """
    import numpy as np

    from grid_tpu.io.formats import read_counts_tsv, write_dipcn
    from grid_tpu.steps.neighbors import load_neighbor_geometry
    from grid_tpu.utils.device import step_device

    dcfg = shared_config.get("compute_diploid_genotypes", {})
    n_nbr = dcfg.get("n_nbr", 300)

    sample_ids, zp, scales, _r_use, k = load_neighbor_geometry(
        shared_config, console
    )
    n = len(sample_ids)
    written: dict[str, Path] = {}
    if n == 0:
        for gene, cfg in locus_cfgs.items():
            path = _dipcn_file(cfg)
            write_dipcn(path, [], [])
            written[gene] = path
        return written

    scale_vec = np.array([scales[sid] for sid in sample_ids], dtype=np.float64)
    genes = list(locus_cfgs)
    reads_per_gene = {g: read_counts_tsv(_counts_file(locus_cfgs[g])) for g in genes}

    # group loci sharing a usability pattern (one-pass ingest => one group)
    groups: dict[bytes, list[str]] = {}
    usable_per_gene = {}
    for g in genes:
        reads = reads_per_gene[g]
        usable = np.array([sid in reads for sid in sample_ids], dtype=bool)
        usable_per_gene[g] = usable
        groups.setdefault(usable.tobytes(), []).append(g)

    import jax.numpy as jnp

    from grid_tpu.ops.knn import d2_matrix
    from grid_tpu.ops.select import (
        dipcn_from_distances_multi,
        dipcn_from_distances_panels,
    )

    d2_budget = 2 << 30
    resident = n * n * zp.dtype.itemsize <= d2_budget

    log(console,
        f"Batched dipCN: {len(genes)} loci in {len(groups)} device call(s) "
        f"(N={n}, k={k}, {'resident d2' if resident else 'row panels'})",
        style="info")

    for key, group in groups.items():
        usable = usable_per_gene[group[0]]
        w = np.zeros((n, len(group)), dtype=np.float64)
        for j, g in enumerate(group):
            reads = reads_per_gene[g]
            vals = np.array(
                [reads.get(sid, 0.0) for sid in sample_ids], dtype=np.float64
            )
            w[:, j] = np.where(usable, vals / scale_vec, 0.0)
        valid = np.broadcast_to(usable[:, None], w.shape)

        with step_device(shared_config, n * n + w.size):
            if resident:
                d2 = d2_matrix(zp)
                dip, ok = dipcn_from_distances_multi(
                    d2, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
                    jnp.asarray(valid), k=k, n_nbr=n_nbr,
                )
            else:
                dip, ok = dipcn_from_distances_panels(
                    zp, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
                    jnp.asarray(valid), k=k, n_nbr=n_nbr,
                    row_valid=jnp.ones(n, bool),
                )
            dip, ok = np.asarray(dip), np.asarray(ok)

        for j, g in enumerate(group):
            sel = ok[:, j]
            out_ids = [sid for i, sid in enumerate(sample_ids) if sel[i]]
            out_vals = [float(v) for v in dip[sel, j]]
            path = _dipcn_file(locus_cfgs[g])
            write_dipcn(path, out_ids, out_vals)
            log(console, f"[{g}] saved {len(out_ids)} samples → {path}",
                style="success")
            written[g] = path
    return written


def run_multi_locus(config, genes, console=None, catalog=None, batched="auto"):
    """Run the WGS pipeline across many catalog loci, sharing the
    locus-independent steps.

    Phase 1 (once): index check/create, genome-binned coverage, normalize,
    find_neighbors — the base config's steps 1, 3, 4, 5. When the one-pass
    native ingest is active, EVERY locus' step-2 window count is a
    byproduct of the same scan (native multi-window counting) — no
    per-locus passes over the alignment files at all.
    Batched step 6 (once): dipCN for all loci as one [N, N] @ [N, L]
    device computation (:func:`run_batched_dipcn`).
    Phase 2 (per locus): whatever remains per locus — count_reads only
    when the shared scan could not produce it, dipCN only when batching is
    off, optional native IBS (focal re-centered) + phasing.

    Args:
        config: dict or YAML path (base config; its chrom/start/end are
            overridden per locus).
        genes: gene names resolved against the VNTR catalog.
        catalog: optional catalog path (default: bundled 734-region table).
        batched: True/False/"auto" — batch step 6 across loci ("auto":
            whenever dipCN is gated on and >1 locus).

    Returns {gene: locus} for the loci that ran.
    """
    from grid_tpu.config import apply_defaults, error_check_config, load_config
    from grid_tpu.pipeline import run_wgs_pipeline
    from grid_tpu.steps.ingest import fused_ingest_enabled

    if isinstance(config, (str, Path)):
        config = load_config(config)
    error_check_config(config, console)
    config = apply_defaults(config)

    loci = {g: resolve_locus(g, catalog) for g in genes}
    cfgs = {g: locus_config(config, locus) for g, locus in loci.items()}

    counts_on = config.get("count_reads", {}).get("run") is True
    dipcn_on = config.get("compute_diploid_genotypes", {}).get("run") is True
    if batched == "auto":
        batched = dipcn_on and len(loci) > 1

    # ---- phase 1: locus-independent cohort work (run once) --------------
    shared = copy.deepcopy(config)
    for section in ("count_reads", "compute_ibs", "compute_diploid_genotypes",
                    "compute_haploid_genotypes"):
        shared.setdefault(section, {})["run"] = False
    shared.setdefault("device", {})["fused"] = False  # fused needs all of 4-7
    if counts_on and fused_ingest_enabled(shared):
        # every locus window counted inside the one scan
        shared["_extra_count_windows"] = [
            {
                "chrom": loci[g].chrom,
                "start": loci[g].start,
                "end": loci[g].end,
                "counts_path": _counts_file(cfgs[g]),
            }
            for g in loci
        ]
    log(console, f"Multi-locus sweep: shared steps (coverage/normalize/kNN) "
                 f"for {len(loci)} loci", style="info")
    run_wgs_pipeline(console, shared, validate=False)
    shared.pop("_extra_count_windows", None)

    counts_done = {
        g: counts_on and _counts_file(cfgs[g]).exists() for g in loci
    }

    # ---- phase 2a: per-locus counting, only where the scan missed -------
    for gene, locus in loci.items():
        if not counts_on or counts_done[gene]:
            continue
        log(console, f"[{gene}] count_reads "
                     f"{locus.chrom}:{locus.start:,}-{locus.end:,}",
            style="info")
        cfg = copy.deepcopy(cfgs[gene])
        cfg.setdefault("index", {})["run"] = None
        for section in ("compute_ibs", "compute_diploid_genotypes",
                        "compute_haploid_genotypes"):
            cfg.setdefault(section, {})["run"] = False
        for path in (("mosdepth",), ("mosdepth", "normalize"),
                     ("mosdepth", "neighbors")):
            sec = cfg
            for kkey in path:
                sec = sec.setdefault(kkey, {})
            sec["run"] = False
        cfg.setdefault("device", {})["fused"] = False
        run_wgs_pipeline(console, cfg, validate=False)
        counts_done[gene] = True

    # ---- batched step 6 --------------------------------------------------
    dipcn_done = set()
    if batched and dipcn_on:
        dipcn_done = set(run_batched_dipcn(config, cfgs, console))

    # ---- phase 2b: remaining per-locus window steps ----------------------
    for gene, locus in loci.items():
        cfg = cfgs[gene]
        # the shared steps are done; disable them in the per-locus pass
        cfg.setdefault("index", {})["run"] = None
        for path in (("mosdepth",), ("mosdepth", "normalize"), ("mosdepth", "neighbors")):
            sec = cfg
            for kkey in path:
                sec = sec.setdefault(kkey, {})
            sec["run"] = False
        cfg.setdefault("device", {})["fused"] = False
        if counts_done.get(gene):
            cfg.setdefault("count_reads", {})["run"] = False
        if gene in dipcn_done:
            cfg.setdefault("compute_diploid_genotypes", {})["run"] = False
        remaining = [
            s for s in ("count_reads", "compute_ibs",
                        "compute_diploid_genotypes", "compute_haploid_genotypes")
            if cfg.get(s, {}).get("run") is True
        ]
        if not remaining:
            continue
        log(console, f"[{gene}] {locus.chrom}:{locus.start:,}-{locus.end:,} "
                     f"({', '.join(remaining)})", style="info")
        run_wgs_pipeline(console, cfg, validate=False)
    return loci
