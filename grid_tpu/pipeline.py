"""WGS pipeline orchestrator.

Step-gating and failure semantics match the reference
(``grid/pipeline.py:9-103``): each step runs iff its section has
``run: True``; a step exception is logged and the pipeline continues to the
next step (downstream steps then fail on missing inputs — by design, so a
cohort operator can re-run individual steps).

grid_tpu improvements over the reference orchestrator:

- the config validator is actually invoked (fixes quirk Q1,
  grid/pipeline.py:20-21 TODO) and defaults are resolved once;
- per-step wall-clock timing is recorded and dumped next to the artifacts
  (``step_timings.json``), with optional ``jax.profiler`` traces via
  ``GRID_TPU_PROFILE_DIR``;
- content-addressed skip: a step whose output already exists and whose
  config+inputs are unchanged can be skipped with ``resume: true``.
"""

from __future__ import annotations

import hashlib
import json
import zlib
from pathlib import Path

from grid_tpu.config import apply_defaults, error_check_config, load_config
from grid_tpu.utils.logging import log
from grid_tpu.utils.timing import StepTimer, step_timer


def _file_stat(path) -> tuple:
    """(size, crc32(head), crc32(tail)) of a file, or ("missing",).

    Content-based (64 KiB head + tail), NOT mtime-based: a regenerated but
    identical upstream file stays valid, and an rsync/git-checkout that
    preserves mtimes but changes bytes invalidates (the round-1 proxy used
    mtime+size and had both failure modes)."""
    try:
        p = Path(path)
        size = p.stat().st_size
        chunk = 65536
        with open(p, "rb") as f:
            head = zlib.crc32(f.read(chunk))
            if size > chunk:
                f.seek(max(size - chunk, 0))
                tail = zlib.crc32(f.read(chunk))
            else:
                tail = head
        return (size, head, tail)
    except OSError:
        return ("missing",)


def _step_inputs(name: str, config: dict) -> list:
    """The on-disk inputs whose change must invalidate a cached step."""
    out_dir = Path(config.get("output_dir", "."))
    ft = config.get("output_file_type", "tsv")
    m = config.get("mosdepth", {})

    def prefix(section, key="output_file_prefix"):
        return section.get(key) if isinstance(section, dict) else None

    if name == "normalize":
        work = m.get("work_dir")
        if work and Path(work).is_dir():
            return sorted(str(p) for p in Path(work).glob("*.regions.bed.gz"))
        return []
    if name == "neighbors":
        return [out_dir / f"{prefix(m.get('normalize', {}))}.{ft}.gz"]
    if name == "compute_diploid_genotypes":
        zmax = m.get("neighbors", {}).get("zmax", 2.0)
        return [
            out_dir / f"{prefix(config.get('count_reads', {}))}.{ft}",
            out_dir / f"{prefix(m.get('neighbors', {}))}.zMax{zmax:.1f}.{ft}.gz",
        ]
    if name == "compute_haploid_genotypes":
        h = config.get("compute_haploid_genotypes", {})
        inputs = [out_dir / f"{prefix(config.get('compute_diploid_genotypes', {}))}.{ft}"]
        for key in ("ibs_output", "ibd_output"):
            if h.get(key):
                inputs.append(h[key])
        return inputs
    return []


def _step_fingerprint(name: str, config: dict) -> str:
    """Hash of the step-relevant config AND the stat signature of the step's
    input files, so regenerated upstream artifacts (or parameter changes in
    upstream sections that determine input filenames) invalidate the skip."""
    relevant = {
        "global": {
            k: config.get(k)
            for k in ("samples_file", "chrom", "start_bp", "end_bp", "output_dir", "min_mapq")
        },
        "step": config.get(name, {}),
        "mosdepth": config.get("mosdepth", {})
        if name in ("normalize", "neighbors", "compute_diploid_genotypes")
        else None,
        "inputs": [(str(p), _file_stat(p)) for p in _step_inputs(name, config)],
    }
    return hashlib.sha256(json.dumps(relevant, sort_keys=True, default=str).encode()).hexdigest()


class _Resume:
    """Step-level resume bookkeeping (``<output_dir>/.grid_tpu_state.json``)."""

    def __init__(self, config):
        self.enabled = bool(config.get("resume", False))
        self.path = Path(config.get("output_dir", ".")) / ".grid_tpu_state.json"
        self.state = {}
        if self.path.exists():
            try:
                self.state = json.loads(self.path.read_text())
            except Exception:
                self.state = {}

    def should_skip(self, name, config) -> bool:
        if not self.enabled:
            return False
        rec = self.state.get(name)
        return bool(rec) and rec.get("fingerprint") == _step_fingerprint(name, config) and all(
            Path(p).exists() for p in rec.get("outputs", [])
        )

    def mark(self, name, config, outputs):
        # always record (cheap), so the FIRST `resume: true` run benefits
        # from state written by earlier non-resume runs
        self.state[name] = {
            "fingerprint": _step_fingerprint(name, config),
            "outputs": [str(p) for p in outputs if p],
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.state, indent=2))


def run_wgs_pipeline(console=None, config=None, validate: bool = True):
    """Run the seven-step WGS pipeline from a YAML config path or dict."""
    if not config:
        raise ValueError("Config file is required for running the WGS pipeline.")

    if isinstance(config, (str, Path)):
        try:
            config_data = load_config(config)
        except Exception as e:
            raise ValueError(f"Failed to read the config file: {e}") from e
    else:
        config_data = config

    if validate:
        error_check_config(config_data, console)
    config_data = apply_defaults(config_data)

    from grid_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()
    Path(config_data.get("output_dir", ".")).mkdir(parents=True, exist_ok=True)

    timer = StepTimer()
    resume = _Resume(config_data)

    def gated(section, name, fn):
        """Run one step with reference failure semantics (log + continue)."""
        if section.get("run") is not True:
            return
        if resume.should_skip(name, config_data):
            log(console, f"[{name}] up-to-date, skipped (resume)", style="info")
            return
        try:
            with step_timer(name, timer, console):
                out = fn(config_data, console)
            resume.mark(name, config_data, [out] if not isinstance(out, (list, tuple)) else out)
        except Exception as e:
            log(console, f"Failed to run {name}: {e}", style="danger")

    # Steps 1: index check/create (ref: pipeline.py:24-43 — check when
    # run == False, create when run == True).
    index_cfg = config_data.get("index", {})
    if index_cfg.get("run") is False:
        from grid_tpu.steps.index import check_index

        try:
            with step_timer("check_index", timer, console):
                check_index(config_data, console)
        except Exception as e:
            log(console, f"Failed to check index: {e}", style="danger")
    elif index_cfg.get("run") is True:
        from grid_tpu.steps.index import create_index

        try:
            with step_timer("create_index", timer, console):
                create_index(config_data, console)
        except Exception as e:
            log(console, f"Failed to create index: {e}", style="danger")

    from grid_tpu.steps.count_reads import count_reads
    from grid_tpu.steps.coverage import compute_mosdepth
    from grid_tpu.steps.dipcn import compute_diploid_genotypes
    from grid_tpu.steps.haploid import hi_inference
    from grid_tpu.steps.neighbors import find_neighbors
    from grid_tpu.steps.normalize import normalize_mosdepth

    # Steps 2+3 (+ the staging scan) as ONE native pass per sample when the
    # one-pass ingest is available (steps/ingest.py) — the reference's
    # three-pass shape (pysam count, mosdepth, normalize re-scan) is ~85%
    # of real-cohort wall-clock. Artifacts stay byte-identical; resume
    # state is recorded under the classic step names so either mode can
    # resume the other's outputs.
    from grid_tpu.steps.ingest import fused_ingest_enabled, run_fused_ingest

    ingest_done = False
    if fused_ingest_enabled(config_data):
        cr_on = config_data.get("count_reads", {}).get("run") is True
        skip_cr = (not cr_on) or resume.should_skip("count_reads", config_data)
        skip_md = resume.should_skip("mosdepth", config_data)
        if skip_cr and skip_md:
            log(console,
                "[count_reads+mosdepth] up-to-date, skipped (resume)"
                if cr_on else "[mosdepth] up-to-date, skipped (resume)",
                style="info")
            ingest_done = True
        elif cr_on and (skip_cr or skip_md):
            # exactly one step is up to date: the fused pass would rewrite
            # (and on a mid-run crash, truncate) the valid artifact — keep
            # the sequential steps' finer-grained resume instead
            log(console, "one of steps 2/3 is up-to-date; running them"
                " sequentially to preserve resume state", style="info")
        else:
            try:
                # when the normalize stage will stream (bounded-memory mode
                # for huge cohorts), don't accumulate per-sample arrays here
                from grid_tpu.steps.normalize import stage_would_stream

                collect = not stage_would_stream(config_data)
                with step_timer("fused_ingest_2_3", timer, console):
                    counts_path, coverage_path, staged = run_fused_ingest(
                        config_data, console, collect_staged=collect
                    )
                if staged is not None:
                    config_data["_ingest_staged"] = staged
                if counts_path is not None:
                    resume.mark("count_reads", config_data, [counts_path])
                resume.mark("mosdepth", config_data, [coverage_path])
                ingest_done = True
            except Exception as e:
                log(
                    console,
                    f"One-pass ingest failed ({e}); falling back to sequential steps 2-3",
                    style="warning",
                )
    if not ingest_done:
        gated(config_data.get("count_reads", {}), "count_reads", count_reads)
        gated(config_data.get("mosdepth", {}), "mosdepth", compute_mosdepth)

    # grid_tpu addition: native IBS neighbor generation from a phased panel
    # (the reference requires an externally-prepared computeIBSpbwt file).
    # Must run before steps 4-7 (fused or sequential) — its output feeds
    # step 7's ibs_output.
    if config_data.get("compute_ibs", {}).get("run") is True:
        from grid_tpu.steps.ibs import compute_ibs, default_ibs_output

        # Derive the downstream ibs_output default BEFORE the gated call:
        # a resume-skipped compute_ibs must still point hi_inference at the
        # existing neighbors file (the step body's setdefault never runs
        # when the step is skipped).
        hap_cfg = config_data.setdefault("compute_haploid_genotypes", {})
        if not hap_cfg.get("ibs_output"):
            hap_cfg["ibs_output"] = str(default_ibs_output(config_data))
        gated(config_data.get("compute_ibs", {}), "compute_ibs", compute_ibs)

    from grid_tpu.steps.fused import fused_steps_enabled, run_fused_steps

    fused_done = False
    if fused_steps_enabled(config_data):
        # steps 4-7 as one staged ingest + one fused device program
        try:
            with step_timer("fused_steps_4_7", timer, console):
                run_fused_steps(config_data, console, timer)
            fused_done = True
        except Exception as e:
            log(
                console,
                f"Fused steps 4-7 failed ({e}); falling back to sequential steps",
                style="warning",
            )
    if not fused_done:
        gated(config_data.get("mosdepth", {}).get("normalize", {}), "normalize", normalize_mosdepth)
        gated(config_data.get("mosdepth", {}).get("neighbors", {}), "neighbors", find_neighbors)
        gated(
            config_data.get("compute_diploid_genotypes", {}),
            "compute_diploid_genotypes",
            compute_diploid_genotypes,
        )
        gated(
            config_data.get("compute_haploid_genotypes", {}),
            "compute_haploid_genotypes",
            hi_inference,
        )

    try:
        timer.dump(Path(config_data.get("output_dir", ".")) / "step_timings.json")
    except Exception:
        pass
    return timer.report()


def run_wes_pipeline(console=None, config=None, validate: bool = True):
    """Run the exome (WES) pipeline: realign -> per-exon dipCN -> KIV-2
    estimate.

    The reference ships only a commented-out ``WES(config)`` CLI stub
    calling a ``run_wes_pipeline`` that does not exist (grid/cli.py:94-113);
    grid_tpu implements it over the working exon path: Smith-Waterman
    realignment of window reads against the exon references
    (models/realign.py), the legacy per-exon dipCN semantics
    (models/kiv.py, ref compute_dipcn_dir/), and the KIV-2 linear estimate
    (ref utils/estimate_kiv.py:22-24). Step gating and log-and-continue
    failure semantics match the WGS orchestrator.
    """
    if not config:
        raise ValueError("Config file is required for running the WES pipeline.")
    if isinstance(config, (str, Path)):
        config_data = load_config(config)
    else:
        config_data = config

    from grid_tpu.config import WES_SCHEMA

    if validate:
        error_check_config(config_data, console, schema=WES_SCHEMA)
    config_data = apply_defaults(config_data, schema=WES_SCHEMA)
    out_dir = Path(config_data.get("output_dir", "."))
    out_dir.mkdir(parents=True, exist_ok=True)
    ft = config_data.get("output_file_type", "tsv")
    timer = StepTimer()

    def gated(name, fn):
        section = config_data.get(name, {})
        if section.get("run") is not True:
            return
        try:
            with step_timer(name, timer, console):
                fn(section)
        except Exception as e:
            log(console, f"Failed to run {name}: {e}", style="danger")

    index_cfg = config_data.get("index", {})
    if index_cfg.get("run") is True:
        from grid_tpu.steps.index import create_index

        try:
            with step_timer("create_index", timer, console):
                create_index(config_data, console)
        except Exception as e:
            log(console, f"Failed to create index: {e}", style="danger")

    counts_file = out_dir / f"{config_data.get('realign', {}).get('output_file_prefix', 'exon_counts')}.{ft}"

    def _realign(section):
        from grid_tpu.models.realign import run_realignment

        run_realignment(
            config_data["directory_loc"],
            section["exon_fasta"],
            config_data["chrom"],
            config_data["start_bp"],
            config_data["end_bp"],
            counts_file,
            min_score=section.get("min_score", 30),
            margin=section.get("margin", 3),
            threads=config_data.get("threads", 1),
            console=console,
        )

    dipcn_prefix = out_dir / f"{config_data.get('exon_dipcn', {}).get('output_file_prefix', 'exon_dipcn')}"

    def _exon_dipcn(section):
        from grid_tpu.models.kiv import compute_dipcn_for_exon
        from grid_tpu.models.kiv_io import (
            load_count_results,
            load_neighbor_results,
            validate_sample_overlap,
            write_dipcn_output,
        )

        counts = load_count_results(counts_file)
        nbrs = load_neighbor_results(section["neighbors_file"])
        n_overlap, _ = validate_sample_overlap(counts, nbrs, console)
        if n_overlap == 0:
            raise ValueError("No overlapping samples between exon counts and neighbors")
        for exon_type in section.get("exon_types", ["1A", "1B"]):
            res = compute_dipcn_for_exon(
                counts, nbrs, exon_type, section.get("n_neighbors", 200)
            )
            out = Path(f"{dipcn_prefix}.{exon_type}.{ft}")
            write_dipcn_output(res, out)
            log(console, f"{exon_type} dipCN for {len(res)} samples → {out}", style="success")

    def _estimate(section):
        from grid_tpu.models.kiv import estimate_kiv_files

        out = out_dir / f"{section.get('output_file_prefix', 'kiv2_estimates')}.{ft}"
        n = estimate_kiv_files(
            Path(f"{dipcn_prefix}.1A.{ft}"), Path(f"{dipcn_prefix}.1B.{ft}"), out
        )
        log(console, f"KIV2 estimates for {n} samples → {out}", style="success")

    gated("realign", _realign)
    gated("exon_dipcn", _exon_dipcn)
    gated("estimate_kiv", _estimate)

    try:
        timer.dump(out_dir / "step_timings.json")
    except Exception:
        pass
    return timer.report()
