"""Shared ctypes plumbing for the fused one-pass ingest wrappers.

grid_bam_ingest_multi and grid_cram_ingest_multi have identical C signatures
and return contracts (see src/bam.cpp for the semantics); this module holds
the one implementation both grid_tpu.native.bam.ingest and
grid_tpu.native.cram.ingest delegate to, so fixes to the buffer sizing /
retry behavior cannot drift.
"""

from __future__ import annotations

import ctypes as _ct
import os

import numpy as np

_ARGTYPES = [
    _ct.c_char_p, _ct.c_char_p, _ct.c_int32, _ct.c_int32, _ct.c_int32,
    _ct.c_int32, _ct.c_char_p, _ct.c_int64, _ct.c_int64,
    _ct.POINTER(_ct.c_int32), _ct.c_int32, _ct.c_int32, _ct.c_char_p,
    _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_int64),
    _ct.POINTER(_ct.c_int32), _ct.POINTER(_ct.c_int64),
    _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_double),
    _ct.c_int64, _ct.POINTER(_ct.c_int64),
    # extra count-only windows (multi-locus sweep)
    _ct.c_char_p, _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_int64),
    _ct.c_int32, _ct.POINTER(_ct.c_int64),
]

_I64P = _ct.POINTER(_ct.c_int64)
_I32P = _ct.POINTER(_ct.c_int32)
_F64P = _ct.POINTER(_ct.c_double)


def _window_cap(start, end, bin_size):
    return 4 * ((int(end) - int(start)) // int(bin_size) + 2) + 1024


def _marshal_shared(flags, chrom, stage_chrom_prefix, windows):
    """Arg marshalling shared by the per-file and batched calls — ONE
    implementation of the flag ordering, the chr-prefix rule, and the
    window-buffer packing, so the two dispatch paths cannot drift."""
    flag_list = sorted(int(f) for f in flags)
    prefix = stage_chrom_prefix
    if prefix is None:
        c = str(chrom)
        prefix = c if c.startswith("chr") else f"chr{c}"
    n_win = len(windows) if windows else 0
    if n_win:
        win_chroms = b"".join(str(w[0]).encode() + b"\0" for w in windows)
        win_starts = np.array([int(w[1]) for w in windows], np.int64)
        win_ends = np.array([int(w[2]) for w in windows], np.int64)
    else:
        win_chroms = win_starts = win_ends = None
    return flag_list, prefix, n_win, win_chroms, win_starts, win_ends


def ingest_call(cfn, name, path, out_bed_gz, chrom, start, end, flags,
                count_min_mapq=1, bin_size=1000, exclude_flags=1796,
                bin_min_mapq=0, skip_zero=False, stage_chrom_prefix=None,
                windows=None):
    """Invoke a grid_*_ingest_multi C function; returns
    (count, cov100, starts, ends, depths, refids[, win_counts]).

    ``windows``: optional list of (chrom, start, end) extra count-only
    windows, each counted in the same scan (grid_*_ingest_multi). When
    given, the return tuple gains ``win_counts`` — an int64 array with one
    count per window (-1 marks a window whose chromosome raised in the
    per-format sequential semantics, i.e. CRAM-only; the caller writes an
    Error row for it).
    """
    if not getattr(cfn, "_configured", False):
        cfn.restype = _ct.c_int
        cfn.argtypes = _ARGTYPES
        cfn._configured = True

    flag_list, prefix, n_win, win_chroms, win_starts, win_ends = (
        _marshal_shared(flags, chrom, stage_chrom_prefix, windows))
    arr = (_ct.c_int32 * max(len(flag_list), 1))(*(flag_list or [0]))
    if n_win:
        win_counts = np.zeros(n_win, np.int64)
        wargs = (win_chroms, win_starts.ctypes.data_as(_I64P),
                 win_ends.ctypes.data_as(_I64P), n_win,
                 win_counts.ctypes.data_as(_I64P))
    else:
        win_counts = None
        wargs = (None, None, None, 0, None)

    cap = _window_cap(start, end, bin_size)
    for _ in range(3):
        refids = np.empty(cap, np.int32)
        starts = np.empty(cap, np.int64)
        ends = np.empty(cap, np.int64)
        depths = np.empty(cap, np.float64)
        count = _ct.c_int64(0)
        cov100 = _ct.c_int64(0)
        nbins = _ct.c_int64(0)
        rc = cfn(
            str(path).encode(), str(out_bed_gz).encode() if out_bed_gz else b"",
            int(bin_size), int(exclude_flags), int(bin_min_mapq),
            int(bool(skip_zero)), str(chrom).encode(), int(start), int(end),
            arr, len(flag_list), int(count_min_mapq), prefix.encode(),
            _ct.byref(count), _ct.byref(cov100),
            refids.ctypes.data_as(_ct.POINTER(_ct.c_int32)),
            starts.ctypes.data_as(_ct.POINTER(_ct.c_int64)),
            ends.ctypes.data_as(_ct.POINTER(_ct.c_int64)),
            depths.ctypes.data_as(_ct.POINTER(_ct.c_double)),
            cap, _ct.byref(nbins), *wargs,
        )
        if rc == -5:
            cap = int(nbins.value) + 64
            continue
        if rc == -4:
            raise ValueError(f"{name}: chromosome {chrom!r} not found in {path}")
        if rc != 0:
            raise IOError(f"{name}({path}) failed with code {rc}")
        n = int(nbins.value)
        base = (int(count.value), int(cov100.value),
                starts[:n].copy(), ends[:n].copy(), depths[:n].copy(),
                refids[:n].copy())
        return base + (win_counts,) if n_win else base
    raise IOError(f"{name}({path}): staged-bin buffer kept overflowing")


_BATCH_ARGTYPES = [
    _ct.c_char_p, _ct.c_char_p, _I32P, _ct.c_int32, _ct.c_int32,
    _ct.c_int32, _ct.c_int32, _ct.c_int32, _ct.c_int32,
    _ct.c_char_p, _ct.c_int64, _ct.c_int64,
    _I32P, _ct.c_int32, _ct.c_int32, _ct.c_char_p,
    _ct.c_char_p, _I64P, _I64P, _ct.c_int32,
    _I64P, _I64P, _I64P, _I32P,
    _I32P, _I64P, _I64P, _F64P, _ct.c_int64, _I64P, _I64P,
    _F64P, _F64P, _I32P,  # per-thread busy/cpu seconds + threads used
]


def ingest_batch(entries, chrom, start, end, flags, count_min_mapq=1,
                 bin_size=1000, exclude_flags=1796, bin_min_mapq=0,
                 skip_zero=False, stage_chrom_prefix=None, windows=None,
                 threads=0, collect_bins=True, progress=None,
                 thread_stats=None):
    """Whole-cohort fused ingest in ONE native call (grid_ingest_batch,
    src/batch.cpp): worker threads below the GIL pull files off an atomic
    cursor and run the single-file ingest cores, so the GIL-serialized
    Python dispatch the per-sample wrappers pay disappears.

    ``entries``: list of (path, out_bed_gz) — format picked per file by the
    ``.cram`` suffix, matching steps/ingest.py's backend choice. Returns
    ``(status, counts, covs, bins, win_counts)`` where status[i] is the
    per-file rc (0 ok; the caller re-runs failures through its fallback
    chain), bins[i] is ``(starts, ends, depths, refids)`` (or None when
    ``collect_bins`` is off / the file failed), and win_counts is an
    ``[n, n_windows]`` int64 array (or None without windows). ``progress``:
    optional int64[1] ndarray the native side increments once per finished
    file — poll it from another thread for a live bar.

    ``thread_stats``: optional dict, filled on return with
    ``{"busy_s": [...], "cpu_s": [...], "n_threads": used}`` — per-worker
    wall seconds inside the decode cores and thread CPU seconds
    (CLOCK_THREAD_CPUTIME_ID). sum(cpu_s)/wall is the physical
    parallelism achieved (capped by the host's cores); busy >> cpu means
    timeslicing/IO, not dispatch serialization.
    """
    from grid_tpu.native import lib

    n = len(entries)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int64), [], None)

    cfn = lib().grid_ingest_batch
    if not getattr(cfn, "_configured", False):
        cfn.restype = _ct.c_int
        cfn.argtypes = _BATCH_ARGTYPES
        cfn._configured = True

    paths_buf = b"".join(str(p).encode() + b"\0" for p, _ in entries)
    beds_buf = b"".join(
        (str(b).encode() if b else b"") + b"\0" for _, b in entries
    )
    is_cram = np.array(
        [1 if str(p).endswith(".cram") else 0 for p, _ in entries], np.int32
    )

    flag_list, prefix, n_win, win_chroms, win_starts, win_ends = (
        _marshal_shared(flags, chrom, stage_chrom_prefix, windows))
    flag_arr = np.array(flag_list or [0], np.int32)
    if n_win:
        win_counts = np.zeros((n, n_win), np.int64)
        wargs = (win_chroms, win_starts.ctypes.data_as(_I64P),
                 win_ends.ctypes.data_as(_I64P), n_win)
        wc_ptr = win_counts.ctypes.data_as(_I64P)
    else:
        win_counts = None
        wargs = (None, None, None, 0)
        wc_ptr = None

    cap_per = _window_cap(start, end, bin_size) if collect_bins else 0
    counts = np.zeros(n, np.int64)
    covs = np.zeros(n, np.int64)
    status = np.zeros(n, np.int32)
    nbins = np.zeros(n, np.int64)
    if cap_per:
        refids = np.empty(n * cap_per, np.int32)
        starts_a = np.empty(n * cap_per, np.int64)
        ends_a = np.empty(n * cap_per, np.int64)
        depths_a = np.empty(n * cap_per, np.float64)
        bptrs = (refids.ctypes.data_as(_I32P),
                 starts_a.ctypes.data_as(_I64P),
                 ends_a.ctypes.data_as(_I64P),
                 depths_a.ctypes.data_as(_F64P))
    else:
        bptrs = (None, None, None, None)

    # Python decides the thread count and sizes the stats buffers to it;
    # n_threads is never passed as 0, so the C side cannot pick a larger
    # hardware_concurrency and write past the buffers.
    eff_threads = int(threads) if int(threads) > 0 else (os.cpu_count() or 1)
    busy = np.zeros(max(eff_threads, 1), np.float64)
    cpu = np.zeros(max(eff_threads, 1), np.float64)
    nt_used = np.zeros(1, np.int32)
    rc = cfn(
        paths_buf, beds_buf, is_cram.ctypes.data_as(_I32P), n, eff_threads,
        int(bin_size), int(exclude_flags), int(bin_min_mapq),
        int(bool(skip_zero)), str(chrom).encode(), int(start), int(end),
        flag_arr.ctypes.data_as(_I32P), len(flag_list), int(count_min_mapq),
        prefix.encode(), *wargs,
        counts.ctypes.data_as(_I64P), covs.ctypes.data_as(_I64P), wc_ptr,
        status.ctypes.data_as(_I32P), *bptrs, cap_per,
        nbins.ctypes.data_as(_I64P),
        progress.ctypes.data_as(_I64P) if progress is not None else None,
        busy.ctypes.data_as(_F64P), cpu.ctypes.data_as(_F64P),
        nt_used.ctypes.data_as(_I32P),
    )
    if rc != 0:
        raise IOError(f"grid_ingest_batch failed with code {rc}")
    if thread_stats is not None:
        used = int(nt_used[0])
        thread_stats["busy_s"] = busy[:used].tolist()
        thread_stats["cpu_s"] = cpu[:used].tolist()
        thread_stats["n_threads"] = used

    bins = []
    for i in range(n):
        if status[i] != 0 or not cap_per:
            bins.append(None)
            continue
        off, m = i * cap_per, int(nbins[i])
        bins.append((starts_a[off:off + m].copy(), ends_a[off:off + m].copy(),
                     depths_a[off:off + m].copy(),
                     refids[off:off + m].copy()))
    return status, counts, covs, bins, win_counts
