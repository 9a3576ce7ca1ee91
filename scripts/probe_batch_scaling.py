"""Batched-ingest scaling evidence: interleaved
min-of-rounds batch-vs-loop at t1/t2/t4, plus the per-thread busy-time
instrumentation that shows WHERE the wall-clock goes when the host's
physical cores are the ceiling.

    python scripts/probe_batch_scaling.py --out <dir> [--n 256] [--rounds 3]

Reads nothing from the device; fabricates a BAM cohort once and re-uses
it. For each thread count t, one batch call (grid_ingest_batch) and one
per-sample threaded loop run back-to-back per round; min over rounds is
reported. busy_s is the seconds each native worker spent inside the
decode cores: sum(busy)/wall is the effective parallelism — if it
saturates at the physical core count while nominal t rises, the ceiling
is the host, not the GIL/dispatch design.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--aln-dir", default=None,
                    help="reuse an existing BAM directory (skip fabrication);"
                         " requires --chrom/--start/--end")
    ap.add_argument("--chrom", default="chr6")
    ap.add_argument("--start", type=int, default=160_605_000)
    ap.add_argument("--end", type=int, default=160_615_000)
    args = ap.parse_args()

    from grid_tpu.native._ingest import ingest_batch
    from grid_tpu.synth import make_synthetic_cohort_with_alignments

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.aln_dir:
        aln_dir = Path(args.aln_dir)
        chrom, start, end = args.chrom, args.start, args.end
        flags = [83, 147, 81, 145]
        print(f"reusing BAMs in {aln_dir}", flush=True)
    else:
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort_with_alignments(
            out, n_samples=args.n, seed=17, mean_depth=6.0, file_type="bam"
        )
        print(f"fabricated {args.n} BAMs in {time.perf_counter() - t0:.1f}s",
              flush=True)
        cfg = cohort["config"]
        chrom = cfg["chrom"]
        start, end = cfg["start_bp"], cfg["end_bp"]
        flags = cfg["count_reads"]["flags"]
        aln_dir = Path(cfg["directory_loc"])
    bams = sorted(aln_dir.glob("*.bam"))
    scratch = out / "scratch"
    scratch.mkdir(exist_ok=True)
    entries = [(str(p), str(scratch / f"{p.stem}.regions.bed.gz"))
               for p in bams]

    def run_batch(t):
        stats: dict = {}
        t0 = time.perf_counter()
        status, counts, covs, bins, _ = ingest_batch(
            entries, chrom, start, end, flags, threads=t,
            collect_bins=True, thread_stats=stats,
        )
        wall = time.perf_counter() - t0
        assert (status == 0).all(), status
        return wall, stats, counts

    def run_loop(t):
        # the pre-r4 shape: per-sample native calls fanned out by a Python
        # ThreadPool (GIL-serialized dispatch between calls)
        from concurrent.futures import ThreadPoolExecutor

        from grid_tpu.native import bam as nbam
        from grid_tpu.native import cram as ncram

        def one(e):
            path, bed = e
            fn = ncram.ingest if path.endswith(".cram") else nbam.ingest
            return fn(path, bed, chrom, start, end, flags)

        t0 = time.perf_counter()
        if t <= 1:
            res = [one(e) for e in entries]
        else:
            with ThreadPoolExecutor(max_workers=t) as ex:
                res = list(ex.map(one, entries))
        wall = time.perf_counter() - t0
        return wall, [r[0] for r in res]

    ncpu = os.cpu_count()
    report = {"n": len(entries), "rounds": args.rounds, "host_cpus": ncpu,
              "per_thread": {}}
    ref_counts = None
    for t in args.threads:
        best_b, best_l, best_stats = float("inf"), float("inf"), None
        for _ in range(args.rounds):
            wall_b, stats, counts = run_batch(t)
            if wall_b < best_b:
                best_b, best_stats = wall_b, stats
            wall_l, loop_counts = run_loop(t)
            best_l = min(best_l, wall_l)
        if ref_counts is None:
            ref_counts = list(counts)
        assert list(counts) == ref_counts == list(loop_counts), "count drift"
        busy = best_stats.get("busy_s", [])
        cpu = best_stats.get("cpu_s", [])
        report["per_thread"][t] = {
            "batch_s": round(best_b, 2),
            "loop_s": round(best_l, 2),
            "speedup": round(best_l / best_b, 2),
            "busy_s": [round(b, 2) for b in busy],
            "cpu_s": [round(c, 2) for c in cpu],
            "concurrency": round(sum(busy) / best_b, 2) if busy else None,
            "cpu_parallelism": round(sum(cpu) / best_b, 2) if cpu else None,
        }
        print(f"t={t}: batch {best_b:.2f}s loop {best_l:.2f}s "
              f"cpu={[round(c, 2) for c in cpu]} "
              f"cpu_par={report['per_thread'][t]['cpu_parallelism']}",
              flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
