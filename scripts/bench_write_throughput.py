"""CRAM/BAM WRITE-path throughput: measures the writers on the same record
population the reader benchmark decodes.

    python scripts/bench_write_throughput.py --out <dir> [--records 200000] \
        [--rounds 3]

Measured paths (min over rounds, records/s):

- native BAM subset (grid_bam_subset): indexed read + BGZF re-encode of
  every window record — the subset_alignment hot path
  (covers /root/reference/grid/utils/subset_cram.py:26-32).
- bamlite.write_bam: Python BGZF writer over pre-encoded record blobs
  (encode cost reported separately).
- native CRAM writer (grid_cram_write): column packing + series encode,
  ONE ctypes call (verbatim mode, no reference compression).
- cramlite.write_cram: the pure-Python twin (verbatim mode).

Record population: one deep synthetic sample fabricated as BOTH BAM and
CRAM (identical reads, synth.py contract); CRAM records come from a full
CramReader decode (rate printed for context).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    from grid_tpu.io import bamlite, cramlite
    from grid_tpu.native import bam as nbam
    from grid_tpu.native import cram as ncram
    from grid_tpu.synth import make_synthetic_cohort_with_alignments

    out = Path(args.out)
    span = 30_000  # window + flanks of the fabricated sample
    depth = max(args.records * 100 / span, 8)
    t0 = time.perf_counter()
    make_synthetic_cohort_with_alignments(
        out / "bam", n_samples=1, seed=41, mean_depth=depth, depth_sd=0.1,
        file_type="bam",
    )
    make_synthetic_cohort_with_alignments(
        out / "cram", n_samples=1, seed=41, mean_depth=depth, depth_sd=0.1,
        file_type="cram",
    )
    bam_path = next((out / "bam" / "alignments").glob("*.bam"))
    cram_path = next((out / "cram" / "alignments").glob("*.cram"))
    print(f"fabricated {bam_path.stat().st_size / 1e6:.1f} MB BAM + "
          f"{cram_path.stat().st_size / 1e6:.1f} MB CRAM in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    report = {"rounds": args.rounds}

    def best(fn, n_rec):
        b = float("inf")
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            fn()
            b = min(b, time.perf_counter() - t0)
        return round(n_rec / b), round(b, 2)

    # ---- decode the population ------------------------------------------
    t0 = time.perf_counter()
    with cramlite.CramReader(cram_path) as rd:
        refs = list(rd.references)
        recs = list(rd.iter_records())
    t_dec = time.perf_counter() - t0
    n = len(recs)
    report["n_records"] = n
    print(f"decoded {n} CRAM records at {n / t_dec:,.0f} rec/s", flush=True)

    # ---- BAM ------------------------------------------------------------
    sub_path = out / "subset.bam"
    chrom, lo, hi = "chr6", 0, 2_000_000_000
    n_sub = nbam.subset_region(str(bam_path), chrom, lo, hi, str(sub_path))
    rate, t = best(
        lambda: nbam.subset_region(str(bam_path), chrom, lo, hi,
                                   str(sub_path)), n_sub)
    report["bam_native_subset_rec_s"] = rate
    print(f"native BAM subset (read+write, {n_sub} recs): {rate:,} rec/s "
          f"({t}s)", flush=True)

    t0 = time.perf_counter()
    blobs = [
        bamlite.encode_record(
            r.ref_id, r.pos, r.flag, mapq=r.mapq, read_name=r.name,
            cigar=([(ln, op) for op, ln in r.cigar] if r.cigar else None),
            seq=r.seq, next_refid=r.mate_ref_id, next_pos=r.mate_pos,
            tlen=r.tlen,
        )
        for r in recs
    ]
    t_enc = time.perf_counter() - t0
    print(f"  (python record encode: {n / t_enc:,.0f} rec/s)", flush=True)
    rate, t = best(lambda: bamlite.write_bam(out / "py.bam", refs, blobs), n)
    report["bam_python_write_rec_s"] = rate
    print(f"python BAM write (BGZF over blobs): {rate:,} rec/s ({t}s)",
          flush=True)

    # ---- CRAM -----------------------------------------------------------
    rate, t = best(
        lambda: ncram.write_cram(out / "native.cram", refs, recs,
                                 build_index=False), n)
    report["cram_native_write_rec_s"] = rate
    print(f"native CRAM write: {rate:,} rec/s ({t}s)", flush=True)

    rate, t = best(
        lambda: cramlite.write_cram(out / "py.cram", refs, recs,
                                    build_index=False), n)
    report["cram_python_write_rec_s"] = rate
    print(f"python CRAM write: {rate:,} rec/s ({t}s)", flush=True)

    # round-trip sanity: the native CRAM reads back whole
    with cramlite.CramReader(out / "native.cram") as rd:
        n_back = sum(1 for _ in rd.iter_records())
    assert n_back == n, (n_back, n)
    report["roundtrip_ok"] = True
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
