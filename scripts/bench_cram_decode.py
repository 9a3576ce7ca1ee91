"""CRAM/BAM full-scan decode throughput micro-benchmark.

Host-side ingestion micro-benchmark: one synthetic
single-reference file with --n-records reads (default 300k, 100 bp, with
qualities and read names, paired), written once per codec, then timed
through the native full-scan record dump (grid_cram_dump / the BAM ingest
scan). The CRAM is written twice — GZIP blocks and rANS blocks — because
real htslib cohorts are rANS-heavy while our own writers default to gzip.

Usage: python scripts/bench_cram_decode.py [--n-records 300000] [--iters 3]
"""

from __future__ import annotations

import argparse
import ctypes as ct
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def make_records(n, ref_len):
    from grid_tpu.io.cramlite import CramRecord

    rng = np.random.default_rng(7)
    pos = np.sort(rng.integers(0, ref_len - 200, n))
    recs = []
    for i in range(n):
        seq = bytes(rng.choice(list(b"ACGT"), 100).astype(np.uint8)).decode()
        qual = bytes(rng.integers(30, 40, 100, dtype=np.uint8))
        recs.append(
            CramRecord(
                name=f"read{i:07d}",
                flag=99 if i % 2 == 0 else 147,
                ref_id=0,
                pos=int(pos[i]),
                mapq=60,
                seq=seq,
                qual=qual,
                mate_ref_id=0,
                mate_pos=int(pos[i]) + 150,
                tlen=250,
            )
        )
    return recs


def time_native_cram(path, iters):
    from grid_tpu import native

    lib = native.lib()
    fn = lib.grid_cram_dump
    fn.restype = ct.c_int64
    fn.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int64), ct.c_int64]
    n = fn(str(path).encode(), None, 0)
    assert n > 0, f"dump failed: {n}"
    out = np.empty(int(n) * 6, np.int64)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        rc = fn(str(path).encode(), out.ctypes.data_as(ct.POINTER(ct.c_int64)), n)
        dt = time.perf_counter() - t0
        assert rc == n
        best = min(best, dt)
    return int(n), best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-records", type=int, default=300_000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dir", default="/tmp/bench_cram_decode")
    ap.add_argument("--skip-write", action="store_true",
                    help="reuse files from a previous run")
    args = ap.parse_args()

    d = Path(args.dir)
    d.mkdir(parents=True, exist_ok=True)
    ref_len = 50_000_000
    refs = [("chr1", ref_len)]

    from grid_tpu.io import cramlite

    paths = {
        "gzip": d / "cohort_gzip.cram",
        "rans": d / "cohort_rans.cram",
        "light-rans": d / "cohort_light.cram",  # no names/quals (r3 bench shape)
    }
    if not args.skip_write or not all(p.exists() for p in paths.values()):
        recs = make_records(args.n_records, ref_len)
        t0 = time.perf_counter()
        cramlite.write_cram(paths["gzip"], refs, recs, method=cramlite.GZIP,
                            build_index=False)
        t1 = time.perf_counter()
        cramlite.write_cram(paths["rans"], refs, recs, method=cramlite.RANS,
                            build_index=False)
        t2 = time.perf_counter()
        import dataclasses
        light = [dataclasses.replace(r, name="", qual=None) for r in recs]
        cramlite.write_cram(paths["light-rans"], refs, light,
                            method=cramlite.RANS, build_index=False)
        print(f"write: gzip {t1-t0:.1f}s ({paths['gzip'].stat().st_size/1e6:.1f} MB), "
              f"rans {t2-t1:.1f}s ({paths['rans'].stat().st_size/1e6:.1f} MB), "
              f"light {paths['light-rans'].stat().st_size/1e6:.1f} MB")

    for name, p in paths.items():
        n, dt = time_native_cram(p, args.iters)
        print(f"native cram full-scan [{name}]: {n} recs in {dt*1e3:.0f} ms "
              f"= {n/dt/1e6:.2f} Mrec/s")


if __name__ == "__main__":
    main()
