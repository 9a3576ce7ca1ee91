"""Exact sorted top-k-smallest selection via threshold bisection.

An alternative to ``lax.approx_max_k`` in the kNN hot path (the reference
hot loop is ``grid/utils/find_neighbors.py:179-227``). A top-k op must
maintain k-element state per row, which at the pipeline's k=500 is most of
the row; this scheme instead decomposes selection into full-array
compares/reductions (memory-bound), cumulative sums, and tiny gathers:

1. bitcast the non-negative f32 distances to int32 (order-preserving);
2. per-row BISECTION on the key space for the exact k-th smallest key
   (``rounds`` fused compare+count passes over the panel);
3. one pass for tie bookkeeping: count(u < t) and a cumulative tie rank, so
   ties at the threshold break by ascending column exactly like a stable
   argsort (sklearn parity);
4. the compaction permutation comes from a batched binary SEARCH over the
   running count (log2 W gathers of [N, k]) — no scatter, no sort of the
   full row;
5. one stable [N, k] sort orders the k survivors by value.

Everything is O(rounds * N * W) elementwise work + O(N * k * log W) gather —
bounded by memory bandwidth, independent of k's share of the row.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from grid_tpu.ops.knn import GRAM_PRECISION


# order-preserving integer key type per float dtype (values are >= 0, so the
# raw bit pattern as a SIGNED int of the same width is monotone)
_KEY_TYPES = {
    jnp.dtype(jnp.float32): jnp.int32,
    jnp.dtype(jnp.float64): jnp.int64,
    jnp.dtype(jnp.bfloat16): jnp.int16,
    jnp.dtype(jnp.float16): jnp.int16,
}


def _kth_smallest_key(u, k, arity: int = 2):
    """Exact k-th smallest integer key per row of ``u`` [N, W] (keys are
    bitcast from non-negative floats, so non-negative). ``k`` may be a
    static int or a per-row [N] int array (1 <= k <= W; rows with k <= 0
    return an undefined value the caller must mask).

    ``arity``: probes per pass; ``arity - 1`` thresholds per ``u`` read,
    narrowing the interval by log2(arity) bits. Exact for any arity.
    Binary is the default: a pass is not purely read-bound, so the extra
    compare+reduce per pass of a wider arity may cost more than the passes
    it saves. Not measured on the GPU yet.
    """
    n = u.shape[0]
    bits = 8 * u.dtype.itemsize
    kt = u.dtype.type
    k_arr = jnp.asarray(k, jnp.int32)
    if k_arr.ndim == 0:
        k_arr = jnp.full((n,), k_arr)

    import math

    steps = math.ceil((bits - 1) / math.log2(arity))

    def body(_, lohi):
        lo, hi = lohi
        # arity-1 probes at the cell ends of an equal partition of the
        # (span+1)-key interval [lo, hi]: probe_j = lo + ceil((span+1)*j /
        # arity) - 1, computed overflow-safely via span = q*arity + r.
        # Invariant (as in the binary version): count(<= hi) >= k always;
        # the largest surviving cell has ceil((span+1)/arity) keys, so
        # ceil(31/log2(arity)) passes reach span 0 for 32-bit keys.
        new_lo, new_hi = lo, hi
        span = hi - lo
        q = span // arity
        r = span % arity + 1  # span + 1 = q*arity + r, without overflow
        q1 = q + r // arity
        r1 = r % arity
        for j in range(1, arity):
            jj = jnp.asarray(j, lo.dtype)
            mid = lo + q1 * jj + (r1 * jj + (arity - 1)) // arity - 1
            cnt = jnp.sum((u <= mid[:, None]).astype(jnp.int32), axis=1)
            ge = cnt >= k_arr
            new_hi = jnp.where(ge, jnp.minimum(new_hi, mid), new_hi)
            new_lo = jnp.where(ge, new_lo, jnp.maximum(new_lo, mid + 1))
        return new_lo, new_hi

    lo = jnp.zeros((n,), u.dtype)
    hi = jnp.full((n,), kt((1 << (bits - 1)) - 1))
    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return hi


def _tie_cut_column(tie_mask, need, arity: int = 2):
    """Smallest column c such that ``count(tie & col <= c) >= need`` per
    row — the ascending-column tie trim, found by multiway bisection on the
    column index (count passes only; no prefix arrays, no gathers; same
    arity/traffic trade as :func:`_kth_smallest_key`).

    Rows with need <= 0 return -1 (no ties taken)."""
    import math

    n, w = tie_mask.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, w), 1)
    need = jnp.asarray(need, jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        new_lo, new_hi = lo, hi
        span = hi - lo
        q = span // arity
        r = span % arity + 1
        q1 = q + r // arity
        r1 = r % arity
        for j in range(1, arity):
            jj = jnp.asarray(j, jnp.int32)
            mid = lo + q1 * jj + (r1 * jj + (arity - 1)) // arity - 1
            cnt = jnp.sum((tie_mask & (cols <= mid[:, None])).astype(jnp.int32), axis=1)
            ge = cnt >= need
            new_hi = jnp.where(ge, jnp.minimum(new_hi, mid), new_hi)
            new_lo = jnp.where(ge, new_lo, jnp.maximum(new_lo, mid + 1))
        return new_lo, new_hi

    lo = jnp.zeros((n,), jnp.int32)
    hi = jnp.full((n,), w - 1, jnp.int32)
    steps = max(math.ceil(max(int(w - 1).bit_length(), 1) / math.log2(arity)), 1)
    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return jnp.where(need > 0, hi, -1)


def smallest_k_mask(d2, k):
    """Exact membership mask of the k smallest values per row (ties broken
    by ascending column, stable-argsort parity) — [N, W] bool with exactly
    ``min(k, W)`` True per row, built from count passes only.

    ``k`` may be static or per-row [N]; rows with k <= 0 get empty masks.
    """
    key_type = _KEY_TYPES.get(jnp.dtype(d2.dtype))
    if key_type is None:
        raise ValueError(f"unsupported dtype {d2.dtype}")
    u = jax.lax.bitcast_convert_type(d2, key_type)
    t = _kth_smallest_key(u, k)
    below = u < t[:, None]
    at = u == t[:, None]
    k_arr = jnp.asarray(k, jnp.int32)
    if k_arr.ndim == 0:
        k_arr = jnp.full((u.shape[0],), k_arr)
    need = k_arr - jnp.sum(below.astype(jnp.int32), axis=1)
    cut = _tie_cut_column(at, need)
    cols = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)
    mask = below | (at & (cols <= cut[:, None]))
    return jnp.where((k_arr > 0)[:, None], mask, False)


@partial(jax.jit, static_argnames=("k", "n_nbr"))
def dipcn_from_distances(d2, rnorm, nbr_w, col_usable, sample_valid,
                         k: int, n_nbr: int):
    """dipCN straight from the distance matrix — no neighbor-list
    materialization, no [N, k] gathers.

    Exactly equivalent to gathering the k nearest neighbors (ascending,
    stable ties) and running :func:`grid_tpu.ops.dipcn.compute_dipcn`:
    the "first n_nbr usable of the k nearest" prefix becomes a second
    thresholding restricted to usable members of the k-set, and the final
    mean is one masked matvec.

    Args:
        d2: [N, N] pairwise squared distances with self and invalid-row
            columns already set to a large FINITE value.
        rnorm: [N] reads_i / scale_i.
        nbr_w: [N] reads_j / scale_j contribution of each column.
        col_usable: [N] bool — column j may be averaged (has a read count).
        sample_valid: [N] bool.
        k / n_nbr: neighbor-list length and averaging depth.

    Returns (dipcn [N], out_valid [N]) — same contract as compute_dipcn.
    """
    key_type = _KEY_TYPES.get(jnp.dtype(d2.dtype))
    if key_type is None:
        raise ValueError(f"unsupported dtype {d2.dtype}")
    big = jnp.asarray(jnp.iinfo(key_type).max, key_type)

    in_sk = smallest_k_mask(d2, k)
    u = jax.lax.bitcast_convert_type(d2, key_type)
    uu = jnp.where(in_sk & col_usable[None, :], u, big)

    cnt_usable = jnp.sum((uu < big).astype(jnp.int32), axis=1)
    m_eff = jnp.minimum(cnt_usable, n_nbr)

    t_m = _kth_smallest_key(uu, m_eff)
    below = uu < t_m[:, None]
    at = uu == t_m[:, None]
    need = m_eff - jnp.sum(below.astype(jnp.int32), axis=1)
    cut = _tie_cut_column(at, need)
    cols = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 1)
    take = below | (at & (cols <= cut[:, None]))
    take = take & (m_eff > 0)[:, None]

    w = jnp.asarray(nbr_w, d2.dtype)
    tot = jnp.sum(jnp.where(take, w[None, :], 0), axis=1)
    nbr_mean = tot / jnp.maximum(m_eff, 1)
    dipcn = jnp.asarray(rnorm, d2.dtype) / nbr_mean
    out_valid = jnp.asarray(sample_valid, bool) & (m_eff > 0)
    return dipcn, out_valid


@partial(jax.jit, static_argnames=("k", "n_nbr"))
def dipcn_from_lists(d2, sq_dists, nbr_idx, rnorm, nbr_w, col_usable,
                     sample_valid, k: int, n_nbr: int):
    """Threshold dipCN reusing the already-computed sorted kNN lists.

    Selects exactly the same neighbor prefix as
    :func:`dipcn_from_distances` (values agree to f32 summation-order
    tolerance — the take-set is identical but XLA fuses the final masked
    sum differently) while making fewer passes over d2: the
    fused cohort step has ALREADY selected the k
    nearest neighbors (``sq_dists``/``nbr_idx``, the written step-5
    artifact), and those sorted lists contain every order statistic the
    threshold machinery re-derived from scratch —

    - the k-set threshold is ``sq_dists[:, k-1]`` with tie-cut column
      ``nbr_idx[:, k-1]`` (the 31-pass key bisection + 12-pass tie-cut of
      ``smallest_k_mask``, for free);
    - the n_nbr-th *usable* threshold is the list entry at the position
      where the usable-prefix count reaches ``m_eff`` — found by a
      ~log2(k)-pass bisection over list POSITIONS, each probe one fused
      lexicographic compare/count pass over d2 (vs the second 31-pass key
      bisection + tie-cut).

    What remains over d2 is ~12 fused passes instead of ~86.

    PRECONDITION: the lists are the exact k smallest distances per row,
    ascending, ties broken by ascending column — what ``sorted_smallest_k``
    and ``lax.approx_max_k(-d2, k, recall_target=1.0)`` produce, and what
    the written neighbor artifact is pinned to by the reference-parity
    tests. ``tests/test_select.py`` forces distance ties to check the
    bit-parity against :func:`dipcn_from_distances`.

    Args: as :func:`dipcn_from_distances`, plus the [N, k] lists.
    Returns (dipcn [N], out_valid [N]).
    """
    key_type = _KEY_TYPES.get(jnp.dtype(d2.dtype))
    if key_type is None:
        raise ValueError(f"unsupported dtype {d2.dtype}")
    n = d2.shape[0]
    u = jax.lax.bitcast_convert_type(d2, key_type)
    ul = jax.lax.bitcast_convert_type(jnp.asarray(sq_dists, d2.dtype), key_type)
    cols = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)

    def lex_le(t, c):
        """[N] thresholds (value key t, tie column c) -> [N, W] mask of
        entries with (u, col) lexicographically <= (t, c)."""
        return (u < t[:, None]) | ((u == t[:, None]) & (cols <= c[:, None]))

    in_k = lex_le(ul[:, k - 1], nbr_idx[:, k - 1])
    usable = in_k & jnp.asarray(col_usable, bool)[None, :]
    cnt_usable = jnp.sum(usable.astype(jnp.int32), axis=1)
    m_eff = jnp.minimum(cnt_usable, n_nbr)
    need = jnp.maximum(m_eff, 1)  # rows with m_eff == 0 masked at the end

    # smallest list position p with count(usable & lex<=list[p]) >= m_eff;
    # monotone in p because the list is strictly increasing in (value, col)
    lo = jnp.zeros((n,), jnp.int32)
    hi = jnp.full((n,), k - 1, jnp.int32)
    for _ in range(max(int(k - 1).bit_length(), 1)):
        mid = lo + (hi - lo) // 2
        t_p = jnp.take_along_axis(ul, mid[:, None], axis=1)[:, 0]
        c_p = jnp.take_along_axis(nbr_idx, mid[:, None], axis=1)[:, 0]
        cnt = jnp.sum((usable & lex_le(t_p, c_p)).astype(jnp.int32), axis=1)
        ge = cnt >= need
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    t_m = jnp.take_along_axis(ul, hi[:, None], axis=1)[:, 0]
    c_m = jnp.take_along_axis(nbr_idx, hi[:, None], axis=1)[:, 0]

    take = usable & lex_le(t_m, c_m) & (m_eff > 0)[:, None]
    w = jnp.asarray(nbr_w, d2.dtype)
    tot = jnp.sum(jnp.where(take, w[None, :], 0), axis=1)
    nbr_mean = tot / jnp.maximum(m_eff, 1)
    dipcn = jnp.asarray(rnorm, d2.dtype) / nbr_mean
    out_valid = jnp.asarray(sample_valid, bool) & (m_eff > 0)
    return dipcn, out_valid


@partial(jax.jit, static_argnames=("k", "n_nbr"))
def dipcn_from_distances_multi(d2, rnorm, nbr_w, col_usable, sample_valid,
                               k: int, n_nbr: int):
    """Threshold dipCN for MANY loci against ONE distance geometry.

    The multi-locus sweep (grid_tpu extension; the reference is strictly
    single-locus) shares steps 4-5 across loci — the neighbor structure
    depends only on the depth matrix — so per-locus step 6 differs ONLY in
    the read-count weights. With a shared ``col_usable`` (the one-pass
    multi-window ingest guarantees it: a sample errors for all windows of a
    scan or none), the threshold/tie-cut machinery of
    :func:`dipcn_from_distances` is locus-independent and the L masked sums
    collapse into ONE [N, N] @ [N, L] matmul, so 734 catalog loci cost
    barely more than one.

    Per-locus results match :func:`dipcn_from_distances` run in a loop up
    to f32/f64 summation order (the matmul accumulates in a different
    order than the masked row sum; rtol ~1e-9 at f64, ~1e-6 at f32).

    Args:
        d2: [N, N] pairwise squared distances (self/invalid-row columns set
            to a large FINITE value).
        rnorm: [N, L] reads_i / scale_i per locus.
        nbr_w: [N, L] per-column contribution per locus.
        col_usable: [N] bool — SHARED across loci (group loci by usability
            pattern and call once per group when it is not).
        sample_valid: [N, L] bool.
        k / n_nbr: neighbor-list length and averaging depth.

    Returns (dipcn [N, L], out_valid [N, L]).
    """
    key_type = _KEY_TYPES.get(jnp.dtype(d2.dtype))
    if key_type is None:
        raise ValueError(f"unsupported dtype {d2.dtype}")
    big = jnp.asarray(jnp.iinfo(key_type).max, key_type)

    in_sk = smallest_k_mask(d2, k)
    u = jax.lax.bitcast_convert_type(d2, key_type)
    uu = jnp.where(in_sk & col_usable[None, :], u, big)

    cnt_usable = jnp.sum((uu < big).astype(jnp.int32), axis=1)
    m_eff = jnp.minimum(cnt_usable, n_nbr)

    t_m = _kth_smallest_key(uu, m_eff)
    below = uu < t_m[:, None]
    at = uu == t_m[:, None]
    need = m_eff - jnp.sum(below.astype(jnp.int32), axis=1)
    cut = _tie_cut_column(at, need)
    cols = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 1)
    take = below | (at & (cols <= cut[:, None]))
    take = take & (m_eff > 0)[:, None]

    w = jnp.asarray(nbr_w, d2.dtype)  # [N, L]
    tot = jnp.dot(take.astype(d2.dtype), w, precision=GRAM_PRECISION,
                  preferred_element_type=d2.dtype)  # [N, L]
    nbr_mean = tot / jnp.maximum(m_eff, 1)[:, None]
    dipcn = jnp.asarray(rnorm, d2.dtype) / nbr_mean
    out_valid = jnp.asarray(sample_valid, bool) & (m_eff > 0)[:, None]
    return dipcn, out_valid


@partial(jax.jit, static_argnames=("k", "n_nbr", "row_block"))
def dipcn_from_distances_panels(zp, rnorm, nbr_w, col_usable, sample_valid,
                                k: int, n_nbr: int, row_block: int = 512,
                                row_valid=None):
    """Gather-free threshold dipCN WITHOUT the resident [N, N] matrix.

    Extends :func:`dipcn_from_distances` past the d2 device-memory budget
    (~23k rows at 2 GB): stream ROW panels — each lax.scan step materializes one
    [row_block, N] distance panel from the prepared z (one Gram matmul per
    panel, the only [N, N]-order FLOPs) and runs the exact resident core on
    it. A panel holds its rows' ENTIRE distance vectors, so the k-th
    threshold, the tie cut, and the masked sums are exact per row — unlike
    a column-panel decomposition, which cannot see the whole row and would
    need a bisection per narrow panel. Peak memory O(row_block * N); bisection traffic is the
    same 31 x N^2 compare/count bytes as the resident form, just panel-wise.

    Bit-identical to dipcn_from_distances on the same inputs: the panel
    core IS dipcn_from_distances applied to a [B, N] row slice (its
    internals are rectangular), with the same d2 construction as
    ops/knn.d2_matrix (max(0) clamp, self/invalid columns -> finfo.max).

    Args:
        zp: [N, R] prepared z (clipped/filled/region-masked, ops/knn.prepare_z).
        rnorm: [N] reads_i / scale_i — or [N, L] for the multi-locus form
            (see :func:`dipcn_from_distances_multi`; nbr_w and sample_valid
            must then be [N, L] too, and the outputs gain the L axis).
        nbr_w: [N] neighbor contribution per column.
        col_usable: [N] bool — column may be averaged.
        sample_valid: [N] bool — output validity per row.
        k / n_nbr: neighbor-list length and averaging depth.
        row_block: panel height.
        row_valid: [N] bool — rows that exist in the distance geometry
            (columns of ~row_valid rows are masked to finfo.max, exactly
            d2_matrix(row_valid=...)). Defaults to sample_valid. NOTE the
            distinction: a sample without a read count is row_valid (it can
            BE a k-nearest neighbor, occupying a k-slot) but not col_usable
            (it contributes nothing to the mean) — collapsing the two
            changes which neighbors fill the k-set.

    Returns (dipcn [N], out_valid [N]).
    """
    n = zp.shape[0]
    dt = zp.dtype
    big = jnp.asarray(jnp.finfo(dt).max, dt)
    rnorm = jnp.asarray(rnorm, dt)
    multi = rnorm.ndim == 2
    out_valid = jnp.asarray(sample_valid, bool)
    geom = (
        (out_valid if not multi else out_valid.any(axis=1))
        if row_valid is None
        else jnp.asarray(row_valid, bool)
    )

    b = min(row_block, n)
    n_pad = ((n + b - 1) // b) * b
    pad = n_pad - n
    zp_p = jnp.pad(zp, ((0, pad), (0, 0)))
    row_pad = ((0, pad), (0, 0)) if multi else (0, pad)
    rnorm_p = jnp.pad(rnorm, row_pad)
    valid_p = jnp.pad(out_valid, row_pad)

    col_sq = jnp.sum(zp * zp, axis=1)  # [N]
    w = jnp.asarray(nbr_w, dt)
    usable = jnp.asarray(col_usable, bool)
    col_ids = jnp.arange(n, dtype=jnp.int32)

    def panel(carry, i0):
        zrow = jax.lax.dynamic_slice_in_dim(zp_p, i0 * b, b, axis=0)
        vrow = jax.lax.dynamic_slice_in_dim(valid_p, i0 * b, b, axis=0)
        rrow = jax.lax.dynamic_slice_in_dim(rnorm_p, i0 * b, b, axis=0)
        g = jnp.dot(zrow, zp.T, precision=GRAM_PRECISION, preferred_element_type=dt)
        d2 = jnp.sum(zrow * zrow, axis=1)[:, None] + col_sq[None, :] - 2 * g
        d2 = jnp.maximum(d2, 0)
        rows = i0 * b + jax.lax.iota(jnp.int32, b)
        self_mask = rows[:, None] == col_ids[None, :]
        # columns only (+ self), exactly d2_matrix(row_valid=...): invalid
        # ROWS keep their real distances and are gated by sample_valid
        d2 = jnp.where(self_mask | ~geom[None, :], big, d2)
        core = dipcn_from_distances_multi if multi else dipcn_from_distances
        dip, ok = core(d2, rrow, w, usable, vrow, k=k, n_nbr=n_nbr)
        return carry, (dip, ok)

    _, (dips, oks) = jax.lax.scan(
        panel, None, jnp.arange(n_pad // b, dtype=jnp.int32)
    )
    if multi:
        l = rnorm.shape[1]
        return dips.reshape(-1, l)[:n], oks.reshape(-1, l)[:n]
    return dips.reshape(-1)[:n], oks.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("k",))
def sorted_smallest_k(d2, k: int):
    """Exact k smallest values per row with original column indices,
    ascending, ties broken by ascending column (stable-argsort parity).

    Args:
        d2: [N, W] NON-NEGATIVE finite f32 (use finfo.max, not inf, for
            masked entries).
        k: 1 <= k <= W.

    Returns (vals [N, k] ascending, idx [N, k] int32).
    """
    n, w = d2.shape
    key_type = _KEY_TYPES.get(jnp.dtype(d2.dtype))
    if key_type is None:
        raise ValueError(f"unsupported dtype {d2.dtype}")
    u = jax.lax.bitcast_convert_type(d2, key_type)
    t = _kth_smallest_key(u, k)

    below = u < t[:, None]
    at = u == t[:, None]
    c_lt = jnp.sum(below.astype(jnp.int32), axis=1)
    tie_rank = jnp.cumsum(at.astype(jnp.int32), axis=1)
    keep = below | (at & (tie_rank <= (k - c_lt)[:, None]))

    # compaction permutation: first column j with cumsum(keep)[j] == s,
    # for s = 1..k, via batched binary search (no scatter)
    cs = jnp.cumsum(keep.astype(jnp.int32), axis=1)
    targets = jnp.arange(1, k + 1, dtype=jnp.int32)[None, :]
    lo = jnp.zeros((n, k), jnp.int32)
    hi = jnp.full((n, k), w - 1, jnp.int32)
    steps = max(int(w - 1).bit_length(), 1)
    for _ in range(steps):
        mid = lo + (hi - lo) // 2
        v = jnp.take_along_axis(cs, mid, axis=1)
        ge = v >= targets
        lo = jnp.where(ge, lo, mid + 1)
        hi = jnp.where(ge, mid, hi)

    idx = hi
    vals = jnp.take_along_axis(d2, idx, axis=1)
    # order by value; stable keeps ascending-column order among exact ties
    vals, idx = jax.lax.sort((vals, idx), dimension=1, num_keys=1, is_stable=True)
    return vals, idx
