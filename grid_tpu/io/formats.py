"""Reference-compatible on-disk formats (SURVEY §2.3).

Data flow between pipeline steps is file-based, so these formats ARE the
public step API. Each reader/writer documents the reference producer/consumer
it is exchange-compatible with:

1.  samples file — one ID per line              (grid/utils/utils.py:76-78)
2.  read-counts TSV                             (grid/utils/count_reads.py:158-160)
3.  coverage TSV                                (grid/utils/mosdepth.py:296-297)
6.  normalized matrix .tsv.gz                   (grid/utils/normalize_mosdepth.py:515-554)
7.  neighbors .tsv.gz                           (grid/utils/find_neighbors.py:242-267)
8.  dipCN TSV                                   (grid/utils/compute_dipcn.py:99-100)
11. haploid output TSV                          (grid/utils/hi_inference.py:329-337)

(4/5 bed.gz + repeat mask live in :mod:`grid_tpu.io.bed`; 9/10 IBS/IBD inputs
in :mod:`grid_tpu.io.hap_neighbors`.)
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np


# Output gzip level for the large writers. Python's GzipFile default (9)
# is many times slower than level 1 on the N=2504 x k=500 neighbors file
# for a somewhat smaller file; decompressed content — the parity contract — is
# identical either way, and the reference's own .gz headers already differ
# run-to-run (mtime). GRID_TPU_GZ_LEVEL overrides (e.g. 9 for archival).
import os as _os


def _gz_level() -> int:
    """Read at call time so runtime changes to the env var take effect."""
    return int(_os.environ.get("GRID_TPU_GZ_LEVEL", "1"))


def open_maybe_gz(path, mode="rt"):
    """Open plain or gzipped text transparently (ref: grid/utils/utils.py:250-253)."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# ---------------------------------------------------------------- samples ---


def read_samples(samples_file) -> list[str]:
    """One sample ID per line, blanks skipped (ref: grid/utils/utils.py:76-78)."""
    with open(samples_file) as f:
        return [line.strip() for line in f if line.strip()]


def write_samples(samples_file, sample_ids) -> None:
    with open(samples_file, "w") as f:
        for s in sample_ids:
            f.write(f"{s}\n")


# ------------------------------------------------- per-sample value TSVs ---


def setup_output_file(output_file, chrom, start, end) -> Path:
    """Create a TSV with header ``Sample\\t{chrom}:{start}-{end}``
    (ref: grid/utils/utils.py:92-111)."""
    output_path = Path(output_file).expanduser()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        f.write(f"Sample\t{chrom}:{start}-{end}\n")
    return output_path


def write_counts_row(output_file, sample_id, value) -> None:
    """Append one ``ID\\tvalue`` row (counts or coverage TSV)."""
    with open(output_file, "a") as f:
        f.write(f"{sample_id}\t{value}\n")


def read_counts_tsv(path) -> dict[str, float]:
    """Read a counts/coverage TSV into {sample: value}, skipping the header
    and non-numeric rows (matches pandas + to_numeric/dropna semantics of
    grid/utils/compute_dipcn.py:46-49)."""
    out: dict[str, float] = {}
    with open_maybe_gz(path) as f:
        first = True
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            if first:
                first = False
                # header row "Sample\tchrom:start-end" — always skipped
                if parts[0] == "Sample":
                    continue
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                continue
    return out


# ------------------------------------------------ normalized matrix .gz ---


def write_normalized_output(
    path,
    sample_ids,
    sample_scales,
    z_matrix,
    z_mask,
    col_means,
    col_vars,
    selected_indices,
    ratio_mult: float = 100.0,
) -> None:
    """Write the 2-header normalized matrix format
    (ref: grid/utils/normalize_mosdepth.py:502-554).

    Line 0 : N  Rwant  mu_1 ... mu_Rwant           (%.3f, NA for NaN)
    Line 1 : N  Rwant  varRatio_1 ... varRatio_R   (%.3f, NA for NaN)
    Line 2+: ID  scale(%.2f)  z_1 ... z_Rwant      (%.2f, NA for NaN)

    Args:
        sample_ids: N sample IDs (row order).
        sample_scales: per-sample raw mean depth (the ``scale`` column,
            written in 1x units — quirk Q4: this is NOT the 100x coverage
            integer of the coverage TSV).
        z_matrix / z_mask: [N, R] values and validity mask (mask False -> NA).
        col_means / col_vars: per-region stats over ALL R columns.
        selected_indices: column indices to keep, ascending.
    """
    sel = np.asarray(selected_indices, dtype=int)
    n = len(sample_ids)
    r_want = len(sel)
    sel_means = np.asarray(col_means)[sel]
    sel_vars = np.asarray(col_vars)[sel]
    with np.errstate(invalid="ignore", divide="ignore"):
        sel_ratios = np.where(sel_means > 0, ratio_mult * sel_vars / sel_means, np.nan)

    z = np.asarray(z_matrix)
    mask = np.asarray(z_mask)

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    z_sel = z[:, sel]
    m_sel = mask[:, sel]

    # native fast path (native/src/textgz.cpp grid_write_normalized):
    # printf-identical %.2f/%.3f/NA/nan emission + BGZF blocks; decompressed
    # bytes pinned against the Python path (tests/test_io_formats.py).
    if _native_write_normalized(path, sample_ids, sample_scales,
                                z_sel, m_sel, sel_means, sel_ratios):
        return

    def _fmt_row(vals, valid, fmt):
        # vectorized %-formatting (np.char.mod uses the same C printf as
        # f-strings, so output is byte-identical to the per-cell loop)
        safe = np.where(valid, vals, 0.0)
        cells = np.char.mod(fmt, safe)
        return "\t".join(np.where(valid, cells, "NA").tolist())

    with gzip.open(path, "wt", compresslevel=_gz_level()) as out:
        out.write(f"{n}\t{r_want}\t" + _fmt_row(sel_means, ~np.isnan(sel_means), "%.3f") + "\n")
        out.write(f"{n}\t{r_want}\t" + _fmt_row(sel_ratios, ~np.isnan(sel_ratios), "%.3f") + "\n")
        for i, sid in enumerate(sample_ids):
            out.write(
                f"{sid}\t{sample_scales[i]:.2f}\t"
                + _fmt_row(z_sel[i], m_sel[i], "%.2f")
                + "\n"
            )


def read_normalized_data(path):
    """Parse the normalized matrix file
    (ref: grid/utils/find_neighbors.py:81-124).

    Returns:
        sample_ids   : list[str] length N
        sigma2ratios : np.ndarray [Rwant] (NaN for NA)
        data_matrix  : np.ndarray [N, Rwant] float64 (NaN for NA)
        scales       : dict {sample_id: scale}
    """
    sample_ids: list[str] = []
    scales: dict[str, float] = {}
    rows = []
    with gzip.open(path, "rt") as f:
        _ = f.readline()  # header row 0: means (read to advance, unused)
        parts = f.readline().strip().split("\t")
        sigma2ratios = np.array(
            [np.nan if v in ("NA", "nan") else float(v) for v in parts[2:]], dtype=float
        )
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 2:
                continue
            sid = parts[0]
            scale = float(parts[1])
            zvals = [np.nan if v in ("NA", "nan") else float(v) for v in parts[2:]]
            sample_ids.append(sid)
            scales[sid] = scale
            rows.append(zvals)
    data_matrix = np.array(rows, dtype=float)
    return sample_ids, sigma2ratios, data_matrix, scales


# ----------------------------------------------------- neighbors .tsv.gz ---


def neighbors_filename(output_dir, prefix, zmax, file_type="tsv") -> Path:
    """``{prefix}.zMax{zmax:.1f}.{type}.gz`` (ref: grid/utils/find_neighbors.py:45)."""
    return Path(output_dir) / f"{prefix}.zMax{zmax:.1f}.{file_type}.gz"


def write_neighbors(path, sample_ids, scales, nbr_ids, nbr_scales, nbr_norm_dists) -> None:
    """Write the per-sample neighbor list format
    (ref: grid/utils/find_neighbors.py:231-267).

    Per line: ``ID  scale(%.2f)  [nbrID  nbrScale(%.2f)  normDist(%.2f)]*``
    where normDist is squared Euclidean distance / (2 * R_use) — quirk Q5.

    Args:
        sample_ids: N IDs.
        scales: {id: scale} or sequence aligned with sample_ids.
        nbr_ids / nbr_scales / nbr_norm_dists: per-sample sequences of equal
            length (already truncated/ordered).
    """
    if not isinstance(scales, dict):
        scales = {sid: s for sid, s in zip(sample_ids, scales)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", compresslevel=_gz_level()) as out:
        for i, sid in enumerate(sample_ids):
            if len(nbr_ids[i]):
                # vectorized %.2f formatting of the scale/dist columns
                ns = np.char.mod("%.2f", np.asarray(nbr_scales[i], dtype=float))
                nd = np.char.mod("%.2f", np.asarray(nbr_norm_dists[i], dtype=float))
                triplets = "\t".join(
                    f"{nid}\t{a}\t{b}" for nid, a, b in zip(nbr_ids[i], ns, nd)
                )
                out.write(f"{sid}\t{scales.get(sid, 1.0):.2f}\t{triplets}\n")
            else:
                out.write(f"{sid}\t{scales.get(sid, 1.0):.2f}\n")


def write_neighbors_dense(path, sample_ids, scales, nbr_idx, nbr_norm_dists) -> None:
    """Vectorized neighbors writer for dense ``[N, k]`` device outputs
    (fused mode). Byte-identical to :func:`write_neighbors` fed the
    equivalent nested lists, but formats whole columns with ``np.char.mod``
    instead of building N*k Python tuples (ref format:
    grid/utils/find_neighbors.py:231-267).

    Args:
        sample_ids: N IDs (row order).
        scales: ``[N]`` per-sample scales.
        nbr_idx: int ``[N, k]`` neighbor ROW indices into ``sample_ids``.
        nbr_norm_dists: ``[N, k]`` already-normalized distances (sq/(2*R_use));
            pass in the array's native dtype — formatting converts per-element
            exactly like the list path did.
    """
    ids = np.asarray(sample_ids, dtype=object)
    scales = np.asarray(scales)
    nbr_idx = np.asarray(nbr_idx)
    n, k = nbr_idx.shape
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    # native fast path: %.2f-identical cents formatter + BGZF/libdeflate
    # blocks (native/src/textgz.cpp) — the Python path below spends far
    # longer formatting+joining at N=2504/k=500. Same contract:
    # identical decompressed bytes (tests/test_io_formats.py pins it).
    if k and _native_write_neighbors(path, sample_ids, scales, nbr_idx,
                                     nbr_norm_dists):
        return

    own = np.char.mod("%.2f", scales.astype(float))
    cells = np.empty((n, 2 + 3 * k), dtype=object)
    cells[:, 0] = ids
    cells[:, 1] = own
    if k:
        cells[:, 2::3] = ids[nbr_idx]
        cells[:, 3::3] = np.char.mod("%.2f", scales[nbr_idx])
        cells[:, 4::3] = np.char.mod("%.2f", np.asarray(nbr_norm_dists))
    with gzip.open(path, "wt", compresslevel=_gz_level()) as out:
        for row in cells:
            out.write("\t".join(row))
            out.write("\n")


def _native_write_normalized(path, sample_ids, scales, z_sel, m_sel,
                             sel_means, sel_ratios) -> bool:
    """grid_write_normalized via ctypes; False -> Python writer."""
    import os as _os

    if _os.environ.get("GRID_TPU_NATIVE_WRITERS", "1") == "0":
        return False
    if _os.environ.get("GRID_TPU_GZ_LEVEL", "1") != "1":
        # the native sink is fixed at level 1; honor the override by
        # letting the Python writer emit at the requested level
        return False
    try:
        import ctypes as _ct

        from grid_tpu import native

        lib = native.lib()
        ids_buf = b"".join(str(s).encode() + b"\0" for s in sample_ids)
        n = len(sample_ids)
        r = z_sel.shape[1] if z_sel.ndim == 2 else 0
        z64 = np.ascontiguousarray(np.asarray(z_sel, dtype=np.float64))
        m8 = np.ascontiguousarray(np.asarray(m_sel, dtype=np.uint8))
        s64 = np.ascontiguousarray(np.asarray(scales, dtype=np.float64))
        mu64 = np.ascontiguousarray(np.asarray(sel_means, dtype=np.float64))
        ra64 = np.ascontiguousarray(np.asarray(sel_ratios, dtype=np.float64))
        rc = lib.grid_write_normalized(
            str(path).encode(), ids_buf, _ct.c_int64(n), _ct.c_int64(r),
            s64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
            z64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
            m8.ctypes.data_as(_ct.POINTER(_ct.c_uint8)),
            mu64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
            ra64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
        )
        return rc == 0
    except Exception:
        return False


def _native_write_neighbors(path, sample_ids, scales, nbr_idx, dists) -> bool:
    """grid_write_neighbors via ctypes; False -> caller uses the Python
    writer (no native lib, non-ASCII-encodable IDs, or a native error)."""
    import os as _os

    if _os.environ.get("GRID_TPU_NATIVE_WRITERS", "1") == "0":
        return False
    if _os.environ.get("GRID_TPU_GZ_LEVEL", "1") != "1":
        # the native sink is fixed at level 1; honor the override by
        # letting the Python writer emit at the requested level
        return False
    try:
        import ctypes as _ct

        from grid_tpu import native

        lib = native.lib()
        ids_buf = b"".join(str(s).encode() + b"\0" for s in sample_ids)
        scales64 = np.ascontiguousarray(np.asarray(scales, dtype=np.float64))
        idx64 = np.ascontiguousarray(np.asarray(nbr_idx, dtype=np.int64))
        d64 = np.ascontiguousarray(np.asarray(dists, dtype=np.float64))
        n, k = idx64.shape
        rc = lib.grid_write_neighbors(
            str(path).encode(), ids_buf, _ct.c_int64(n), _ct.c_int64(k),
            scales64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
            idx64.ctypes.data_as(_ct.POINTER(_ct.c_int64)),
            d64.ctypes.data_as(_ct.POINTER(_ct.c_double)),
        )
        return rc == 0
    except Exception:
        return False


def read_neighbors(path):
    """Parse a neighbors file (ref: grid/utils/compute_dipcn.py:105-152).

    Returns:
        neighbors     : {sample_id: [(nbr_id, nbr_scale, norm_dist), ...]}
        sample_scales : {sample_id: scale}
    """
    neighbors: dict[str, list[tuple[str, float, float]]] = {}
    sample_scales: dict[str, float] = {}
    with open_maybe_gz(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 2:
                continue
            sid = parts[0]
            try:
                sample_scales[sid] = float(parts[1])
            except ValueError:
                continue
            nbr_list = []
            i = 2
            while i + 2 <= len(parts):
                nid = parts[i]
                try:
                    nscale = float(parts[i + 1])
                    ndist = float(parts[i + 2]) if i + 2 < len(parts) else float("nan")
                except ValueError:
                    i += 3
                    continue
                nbr_list.append((nid, nscale, ndist))
                i += 3
            neighbors[sid] = nbr_list
    return neighbors, sample_scales


# ------------------------------------------------------------- dipCN TSV ---


def write_dipcn(path, sample_ids, values) -> None:
    """``Sample\\tNorm_Reads`` TSV (ref: grid/utils/compute_dipcn.py:99-100).

    pandas ``to_csv`` writes full float repr; match that.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("Sample\tNorm_Reads\n")
        for sid, v in zip(sample_ids, values):
            # str(float) yields the shortest round-trip repr, matching what
            # pandas.to_csv wrote in the reference.
            f.write(f"{sid}\t{float(v)}\n")


def read_dipcn(path):
    """Read a diploid-CN file, skipping non-data rows
    (ref: grid/utils/hi_inference.py:10-31).

    Returns: (ids, irrs, id_to_ind) — list[str], list[float], {id: row}.
    """
    ids: list[str] = []
    irrs: list[float] = []
    id_to_ind: dict[str, int] = {}
    with open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                irr = float(parts[1])
            except ValueError:
                continue  # header row
            id_to_ind[parts[0]] = len(irrs)
            ids.append(parts[0])
            irrs.append(irr)
    return ids, irrs, id_to_ind


# ------------------------------------------------------ haploid output ---


def write_haploid_output(path, sample_ids, irrs, hap1, hap2, imp1, imp2) -> None:
    """``ID IRRs hap1phased hap2phased hap1imp hap2imp`` at %.2f
    (ref: grid/utils/hi_inference.py:329-337)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("ID\tIRRs\thap1phased\thap2phased\thap1imp\thap2imp\n")
        for i, sid in enumerate(sample_ids):
            f.write(
                f"{sid}\t{irrs[i]:.2f}\t{hap1[i]:.2f}\t{hap2[i]:.2f}\t{imp1[i]:.2f}\t{imp2[i]:.2f}\n"
            )
