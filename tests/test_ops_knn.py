"""kNN op tests: self-exclusion, squared distances, region filter parity."""

import numpy as np
import pytest
import jax.numpy as jnp

from grid_tpu.ops import filter_regions_by_variance, region_filter_mask, prepare_z, knn_squared
from grid_tpu.ops.knn import knn_squared_host
from tests.reference_impl import knn_np


def test_knn_matches_bruteforce(rng):
    z = rng.normal(size=(60, 17))
    ref_d2, ref_idx = knn_np(z, 10)
    d2, idx = knn_squared(jnp.asarray(z), 10, row_block=16)
    np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-9, atol=1e-9)
    # neighbor sets must match; order can differ only on exact ties
    for i in range(60):
        assert set(np.asarray(idx)[i].tolist()) == set(ref_idx[i].tolist())


def test_knn_squared_distance_343():
    # dist((0,0) -> (3,4))^2 = 25 (same check as reference test_neighbors).
    z = jnp.asarray([[0.0, 0.0], [3.0, 4.0], [100.0, 100.0]])
    d2, idx = knn_squared(z, 2, row_block=4)
    assert int(np.asarray(idx)[0, 0]) == 1
    np.testing.assert_allclose(float(np.asarray(d2)[0, 0]), 25.0, rtol=1e-12)


def test_knn_excludes_self(rng):
    z = rng.normal(size=(12, 5))
    _, idx = knn_squared(jnp.asarray(z), 11, row_block=4)
    idx = np.asarray(idx)
    for i in range(12):
        assert i not in idx[i]


def test_knn_row_valid_excludes_padding(rng):
    z = rng.normal(size=(10, 4))
    z_pad = np.concatenate([z, np.zeros((6, 4))])
    valid = np.array([True] * 10 + [False] * 6)
    d2, idx = knn_squared(jnp.asarray(z_pad), 5, row_valid=jnp.asarray(valid), row_block=8)
    idx = np.asarray(idx)
    assert (idx[:10] < 10).all()
    ref_d2, ref_idx = knn_np(z, 5)
    np.testing.assert_allclose(np.asarray(d2)[:10], ref_d2, rtol=1e-9, atol=1e-9)


def test_prepare_z_clip_and_fill():
    z = jnp.asarray([[3.5, -4.0, 1.0], [0.5, 2.5, -1.5]])
    mask = jnp.asarray([[True, True, False], [True, True, True]])
    out = np.asarray(prepare_z(z, mask, zmax=2.0))
    np.testing.assert_allclose(out, [[2.0, -2.0, 0.0], [0.5, 2.0, -1.5]])

    region_mask = jnp.asarray([True, False, True])
    out2 = np.asarray(prepare_z(z, mask, zmax=2.0, region_mask=region_mask))
    np.testing.assert_allclose(out2, [[2.0, 0.0, 0.0], [0.5, 0.0, -1.5]])


def test_filter_regions_frac_r_1(rng):
    ratios = np.array([5.0, 80.0, np.nan, 2000.0, 99.0, 1.0])
    idx, r_use = filter_regions_by_variance(ratios, frac_r=1.0, sigma2_max=1000.0)
    # smallest finite (1.0) is the lower bound; 2000 exceeds sigma2_max; NaN out
    assert list(idx) == [0, 1, 4, 5]
    assert r_use == 4

    mask = np.asarray(region_filter_mask(ratios, frac_r=1.0, sigma2_max=1000.0))
    assert list(np.where(mask)[0]) == [0, 1, 4, 5]


def test_filter_regions_all_nan():
    ratios = np.array([np.nan, np.nan, np.nan])
    idx, r_use = filter_regions_by_variance(ratios)
    assert list(idx) == [0, 1, 2] and r_use == 3
    assert np.asarray(region_filter_mask(ratios)).all()


def test_filter_regions_frac_r_partial():
    ratios = np.array([10.0, 20.0, 30.0, 40.0])
    # frac_r=0.5 -> lower_idx = int(4*0.5) = 2 -> sigma2_min = 30
    idx, r_use = filter_regions_by_variance(ratios, frac_r=0.5)
    assert list(idx) == [2, 3]
    mask = np.asarray(region_filter_mask(ratios, frac_r=0.5))
    assert list(np.where(mask)[0]) == [2, 3]


def test_knn_host_matches_device(rng):
    z = rng.normal(size=(30, 8))
    hd2, hidx = knn_squared_host(z, 7)
    dd2, didx = knn_squared(jnp.asarray(z), 7, row_block=16)
    np.testing.assert_allclose(np.asarray(dd2), hd2, rtol=1e-9, atol=1e-9)


def test_knn_two_stage_col_block_matches_flat(rng):
    z = rng.normal(size=(64, 12))
    ref_d, ref_i = knn_squared(jnp.asarray(z), 9, row_block=16, col_block=None)
    d, i = knn_squared(jnp.asarray(z), 9, row_block=16, col_block=16)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), rtol=1e-12)
    for row in range(64):
        assert set(np.asarray(i)[row].tolist()) == set(np.asarray(ref_i)[row].tolist())


def test_knn_col_block_non_dividing_padded(rng):
    z = rng.normal(size=(30, 6))
    # col_block not dividing N: the tail block is +inf padded, results exact
    d, i = knn_squared(jnp.asarray(z), 5, row_block=16, col_block=7)
    ref_d, ref_i = knn_squared(jnp.asarray(z), 5, row_block=16)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), rtol=1e-12)
    for row in range(30):
        assert set(np.asarray(i)[row].tolist()) == set(np.asarray(ref_i)[row].tolist())
    # col_block <= k falls back to flat selection
    d2_, _ = knn_squared(jnp.asarray(z), 5, row_block=16, col_block=4)
    np.testing.assert_allclose(np.asarray(d2_), np.asarray(ref_d), rtol=1e-12)


def test_sorted_smallest_k_matches_stable_argsort(rng):
    from grid_tpu.ops.select import sorted_smallest_k

    for n, w, k in [(8, 16, 3), (33, 100, 10), (64, 64, 64), (50, 300, 1)]:
        d = rng.gamma(2.0, 1.0, (n, w)).astype(np.float32)
        d[d < 0.3] = 0.25  # tie clusters
        d[:, min(5, w - 1)] = d[:, 2]
        vals, idx = map(np.asarray, sorted_smallest_k(jnp.asarray(d), k))
        ref_idx = np.argsort(d, axis=1, kind="stable")[:, :k]
        assert np.array_equal(vals, np.take_along_axis(d, ref_idx, axis=1))
        assert np.array_equal(idx, ref_idx)

    # degenerate all-equal rows: ties break by ascending column
    d = np.full((4, 20), 7.0, np.float32)
    _, idx = map(np.asarray, sorted_smallest_k(jnp.asarray(d), 5))
    assert np.array_equal(idx, np.tile(np.arange(5), (4, 1)))


def test_knn_bisect_selector_matches_host(rng):
    z = rng.normal(size=(57, 13))
    hd2, hidx = knn_squared_host(z, 9)
    d2, idx = knn_squared(jnp.asarray(z), 9, row_block=16, selector="bisect")
    np.testing.assert_allclose(np.asarray(d2), hd2, rtol=1e-6, atol=1e-6)
    for i in range(57):
        assert set(np.asarray(idx)[i].tolist()) == set(hidx[i].tolist())


def test_knn_bisect_row_valid(rng):
    z = rng.normal(size=(10, 4))
    z_pad = np.concatenate([z, np.zeros((6, 4))])
    valid = np.array([True] * 10 + [False] * 6)
    d, i = knn_squared(jnp.asarray(z_pad), 5, row_valid=jnp.asarray(valid),
                       row_block=8, selector="bisect")
    ref_d, ref_i = knn_squared(jnp.asarray(z_pad), 5, row_valid=jnp.asarray(valid),
                               row_block=8)
    i, ref_i = np.asarray(i), np.asarray(ref_i)
    for row in range(10):
        assert set(i[row].tolist()) == set(ref_i[row].tolist())
        assert not (set(i[row].tolist()) & set(range(10, 16)))


def test_dipcn_from_distances_matches_gather_path(rng):
    """Threshold-based dipCN (no gathers, no neighbor materialization) must
    equal compute_dipcn fed the stable-sorted k-nearest lists — including
    tie-heavy quantized data, unusable neighbors, and invalid samples."""
    from grid_tpu.ops.dipcn import compute_dipcn
    from grid_tpu.ops.select import dipcn_from_distances, smallest_k_mask

    for trial in range(4):
        n = int(rng.integers(20, 70))
        r = int(rng.integers(5, 25))
        k = int(rng.integers(2, n - 1))
        n_nbr = int(rng.integers(1, k + 1))
        z = rng.normal(0, 1, (n, r))
        if trial % 2:
            z = np.round(z * 4) / 4  # tie-heavy
        reads = rng.integers(100, 300, n).astype(float)
        scales = rng.uniform(0.5, 2.0, n)
        usable = rng.random(n) > 0.3
        sample_valid = rng.random(n) > 0.1
        w = reads / scales

        d2h, idxh = knn_squared_host(z, k)
        dip_ref, val_ref = compute_dipcn(
            jnp.asarray(w), jnp.asarray(sample_valid),
            jnp.asarray(w[idxh]), jnp.asarray(usable[idxh]), n_nbr,
        )

        sq = np.sum(z**2, axis=1)
        d2 = (sq[:, None] + sq[None, :] - 2 * z @ z.T).clip(0)
        np.fill_diagonal(d2, np.finfo(d2.dtype).max)
        dip, val = dipcn_from_distances(
            jnp.asarray(d2), jnp.asarray(w), jnp.asarray(w),
            jnp.asarray(usable), jnp.asarray(sample_valid), k, n_nbr,
        )
        assert np.array_equal(np.asarray(val), np.asarray(val_ref))
        sel = np.asarray(val)
        np.testing.assert_allclose(
            np.asarray(dip)[sel], np.asarray(dip_ref)[sel], rtol=2e-6
        )
        # membership mask parity with the stable-argsort neighbor sets
        m = np.asarray(smallest_k_mask(jnp.asarray(d2), k))
        ref_mask = np.zeros((n, n), bool)
        np.put_along_axis(ref_mask, idxh, True, axis=1)
        assert np.array_equal(m, ref_mask)


def test_dipcn_from_lists_parity(rng):
    """dipcn_from_lists (thresholds recycled from the sorted kNN lists)
    must select EXACTLY the same neighbor prefix as dipcn_from_distances —
    checked against an independent numpy oracle of the reference semantics
    (stable lex sort, usable prefix of length n_nbr) — including forced
    distance ties, unusable columns, rows whose k-set is all-unusable, and
    lists from both producers (sorted_smallest_k / approx_max_k at recall
    1.0). Values match to f32 summation-order tolerance: the take-set is
    identical, but XLA fuses the final masked sum differently across the
    two programs, so last-ulp equality is not guaranteed."""
    import jax

    from grid_tpu.ops.select import (
        dipcn_from_distances,
        dipcn_from_lists,
        sorted_smallest_k,
    )

    for trial in range(6):
        n = int(rng.integers(20, 70))
        r = int(rng.integers(5, 25))
        k = int(rng.integers(2, n - 1))
        n_nbr = int(rng.integers(1, k + 1))
        z = rng.normal(0, 1, (n, r)).astype(np.float32)
        if trial % 2:
            z = np.round(z * 2) / 2  # tie-heavy quantization
        reads = rng.integers(100, 300, n).astype(np.float32)
        scales = rng.uniform(0.5, 2.0, n).astype(np.float32)
        usable = rng.random(n) > (0.9 if trial == 4 else 0.3)  # trial 4:
        # most columns unusable => rows with m_eff < n_nbr and m_eff == 0
        sample_valid = rng.random(n) > 0.1
        w = reads / scales

        sq = np.sum(z.astype(np.float64) ** 2, axis=1)
        d2 = (sq[:, None] + sq[None, :] - 2 * z.astype(np.float64) @ z.T.astype(np.float64))
        d2 = d2.clip(0).astype(np.float32)
        np.fill_diagonal(d2, np.finfo(np.float32).max)
        d2j = jnp.asarray(d2)

        # numpy oracle: stable lex (value, col) sort -> k-set -> usable
        # prefix of length min(n_nbr, usable count) -> f64 mean
        oracle = np.full(n, np.nan)
        oracle_ok = np.zeros(n, bool)
        for i in range(n):
            order = np.lexsort((np.arange(n), d2[i]))[:k]
            us = [j for j in order if usable[j]]
            m = min(len(us), n_nbr)
            if m > 0:
                oracle[i] = w[i] / (np.sum(w[us[:m]].astype(np.float64)) / m)
                oracle_ok[i] = sample_valid[i]

        want, want_ok = dipcn_from_distances(
            d2j, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
            jnp.asarray(sample_valid), k, n_nbr,
        )
        assert np.array_equal(np.asarray(want_ok), oracle_ok)
        lists = {
            "sorted_smallest_k": sorted_smallest_k(d2j, k),
            "approx_max_k": (lambda neg_idx: (-neg_idx[0], neg_idx[1]))(
                jax.lax.approx_max_k(-d2j, k, recall_target=1.0)
            ),
        }
        for name, (sq_d, idx) in lists.items():
            got, got_ok = dipcn_from_lists(
                d2j, sq_d, idx, jnp.asarray(w), jnp.asarray(w),
                jnp.asarray(usable), jnp.asarray(sample_valid), k, n_nbr,
            )
            assert np.array_equal(np.asarray(got_ok), oracle_ok), name
            sel = oracle_ok
            np.testing.assert_allclose(
                np.asarray(got)[sel], oracle[sel], rtol=2e-6,
                err_msg=f"{name} trial {trial} vs oracle")
            np.testing.assert_allclose(
                np.asarray(got)[sel], np.asarray(want)[sel], rtol=1e-6,
                err_msg=f"{name} trial {trial} vs dipcn_from_distances")


def test_dipcn_from_distances_no_usable_neighbors(rng):
    """Rows whose entire k-set is unusable come back invalid, not NaN-y."""
    from grid_tpu.ops.select import dipcn_from_distances

    n = 12
    z = rng.normal(0, 1, (n, 6))
    sq = np.sum(z**2, axis=1)
    d2 = (sq[:, None] + sq[None, :] - 2 * z @ z.T).clip(0)
    np.fill_diagonal(d2, np.finfo(d2.dtype).max)
    w = np.ones(n)
    usable = np.zeros(n, bool)
    dip, val = dipcn_from_distances(
        jnp.asarray(d2), jnp.asarray(w), jnp.asarray(w),
        jnp.asarray(usable), jnp.ones(n, bool), 5, 3,
    )
    assert not np.asarray(val).any()


class TestPanelDipcn:
    """dipcn_from_distances_panels must be exactly dipcn_from_distances
    without the resident [N, N] matrix (the large-N gather-free path)."""

    def _setup(self, n=97, r=16, seed=0, quantize=True):
        import numpy as np

        rng = np.random.default_rng(seed)
        zp = rng.normal(size=(n, r)).astype(np.float32)
        if quantize:  # 2-decimal z values force exact distance ties
            zp = np.round(zp * 4) / 4
        rnorm = rng.uniform(0.5, 2.0, n).astype(np.float32)
        usable = rng.random(n) > 0.2
        row_valid = rng.random(n) > 0.1
        return zp, rnorm, usable, row_valid

    @pytest.mark.parametrize("row_block", [16, 31, 97, 512])
    def test_matches_resident(self, row_block):
        import jax.numpy as jnp
        import numpy as np

        from grid_tpu.ops.knn import d2_matrix
        from grid_tpu.ops.select import (
            dipcn_from_distances,
            dipcn_from_distances_panels,
        )

        zp, rnorm, usable, row_valid = self._setup()
        k, n_nbr = 20, 7
        d2 = d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(row_valid))
        want, want_ok = dipcn_from_distances(
            d2, jnp.asarray(rnorm), jnp.asarray(rnorm), jnp.asarray(usable),
            jnp.asarray(usable), k=k, n_nbr=n_nbr,
        )
        got, got_ok = dipcn_from_distances_panels(
            jnp.asarray(zp), jnp.asarray(rnorm), jnp.asarray(rnorm),
            jnp.asarray(usable), jnp.asarray(usable),
            k=k, n_nbr=n_nbr, row_block=row_block,
            row_valid=jnp.asarray(row_valid),
        )
        np.testing.assert_array_equal(np.asarray(want_ok), np.asarray(got_ok))
        ok = np.asarray(want_ok)
        np.testing.assert_allclose(
            np.asarray(want)[ok], np.asarray(got)[ok], rtol=0, atol=0
        )

    def test_matches_gather_formulation(self):
        """Panels vs the k-list gather formulation (the semantics contract:
        'first n_nbr usable of the k nearest, stable ties')."""
        import jax.numpy as jnp
        import numpy as np

        from grid_tpu.ops.dipcn import compute_dipcn
        from grid_tpu.ops.knn import d2_matrix
        from grid_tpu.ops.select import dipcn_from_distances_panels, sorted_smallest_k

        zp, rnorm, usable, row_valid = self._setup(n=64, seed=3)
        k, n_nbr = 15, 5
        d2 = d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(row_valid))
        _, idx = sorted_smallest_k(d2, k)
        idx = np.asarray(idx)
        want, want_ok = compute_dipcn(
            jnp.asarray(rnorm), jnp.asarray(usable),
            jnp.asarray(rnorm)[idx], jnp.asarray(usable)[idx], n_nbr=n_nbr,
        )
        got, got_ok = dipcn_from_distances_panels(
            jnp.asarray(zp), jnp.asarray(rnorm), jnp.asarray(rnorm),
            jnp.asarray(usable), jnp.asarray(usable),
            k=k, n_nbr=n_nbr, row_block=17, row_valid=jnp.asarray(row_valid),
        )
        ok = np.asarray(want_ok)
        np.testing.assert_array_equal(ok, np.asarray(got_ok))
        np.testing.assert_allclose(
            np.asarray(want)[ok], np.asarray(got)[ok], rtol=1e-6
        )


class TestMultiwayBisect:
    """The arity knob on the threshold-bisection primitives must be exact
    for every arity (binary is the default; the knob exists for
    re-measurement on other hardware)."""

    @pytest.mark.parametrize("arity", [2, 3, 4, 8])
    def test_kth_smallest_exact(self, arity):
        import numpy as np

        from grid_tpu.ops.select import _kth_smallest_key

        rng = np.random.default_rng(arity)
        for trial in range(60):
            n = int(rng.integers(1, 6))
            w = int(rng.integers(1, 12))
            u = rng.integers(0, 8, size=(n, w)).astype(np.int32)
            if trial % 4 == 0:  # full key range incl. near-max values
                u = rng.integers(0, 2**31 - 1, size=(n, w)).astype(np.int32)
            k = rng.integers(1, w + 1, size=n).astype(np.int32)
            got = np.asarray(
                _kth_smallest_key(jnp.asarray(u), jnp.asarray(k), arity=arity)
            )
            want = np.array([np.sort(u[i])[k[i] - 1] for i in range(n)])
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("arity", [2, 3, 4, 8])
    def test_tie_cut_exact(self, arity):
        import numpy as np

        from grid_tpu.ops.select import _tie_cut_column

        rng = np.random.default_rng(100 + arity)
        for _ in range(60):
            n = int(rng.integers(1, 5))
            w = int(rng.integers(1, 15))
            tie = rng.random((n, w)) < 0.4
            need = rng.integers(-1, 4, size=n).astype(np.int32)
            got = np.asarray(
                _tie_cut_column(jnp.asarray(tie), jnp.asarray(need), arity=arity)
            )
            for i in range(n):
                if need[i] <= 0:
                    assert got[i] == -1
                else:
                    cs = np.cumsum(tie[i])
                    idx = np.where(cs >= need[i])[0]
                    want = idx[0] if len(idx) else w - 1
                    assert got[i] == want


class TestMultiLocusDipcn:
    """dipcn_from_distances_multi: L loci against one distance geometry must
    equal the single-locus threshold dipCN run per locus (the L masked sums
    collapse into one [N, N] @ [N, L] matmul; accumulation-order tolerance
    only)."""

    def _setup(self, n=60, r=12, l=7, seed=0):
        rng = np.random.default_rng(seed)
        zp = np.round(rng.normal(size=(n, r)) * 4) / 4  # tie-heavy
        zp = zp.astype(np.float64)
        reads = rng.integers(50, 400, (n, l)).astype(np.float64)
        scales = rng.uniform(0.5, 2.0, n)
        w = reads / scales[:, None]
        usable = rng.random(n) > 0.25
        sample_valid = (rng.random((n, l)) > 0.1) & usable[:, None]
        return zp, w, usable, sample_valid

    def test_matches_single_locus_loop(self):
        from grid_tpu.ops.knn import d2_matrix
        from grid_tpu.ops.select import (
            dipcn_from_distances,
            dipcn_from_distances_multi,
        )

        zp, w, usable, sample_valid = self._setup()
        k, n_nbr = 14, 5
        d2 = d2_matrix(jnp.asarray(zp))
        got, got_ok = dipcn_from_distances_multi(
            d2, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
            jnp.asarray(sample_valid), k=k, n_nbr=n_nbr,
        )
        got, got_ok = np.asarray(got), np.asarray(got_ok)
        assert got.shape == w.shape and got_ok.shape == w.shape
        for locus in range(w.shape[1]):
            want, want_ok = dipcn_from_distances(
                d2, jnp.asarray(w[:, locus]), jnp.asarray(w[:, locus]),
                jnp.asarray(usable), jnp.asarray(sample_valid[:, locus]),
                k=k, n_nbr=n_nbr,
            )
            np.testing.assert_array_equal(got_ok[:, locus], np.asarray(want_ok))
            ok = np.asarray(want_ok)
            np.testing.assert_allclose(
                got[ok, locus], np.asarray(want)[ok], rtol=1e-9
            )

    def test_panels_multi_matches_resident_multi(self):
        from grid_tpu.ops.knn import d2_matrix
        from grid_tpu.ops.select import (
            dipcn_from_distances_multi,
            dipcn_from_distances_panels,
        )

        zp, w, usable, sample_valid = self._setup(n=53, l=4, seed=5)
        row_valid = np.random.default_rng(9).random(53) > 0.1
        k, n_nbr = 11, 4
        d2 = d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(row_valid))
        want, want_ok = dipcn_from_distances_multi(
            d2, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
            jnp.asarray(sample_valid), k=k, n_nbr=n_nbr,
        )
        got, got_ok = dipcn_from_distances_panels(
            jnp.asarray(zp), jnp.asarray(w), jnp.asarray(w),
            jnp.asarray(usable), jnp.asarray(sample_valid),
            k=k, n_nbr=n_nbr, row_block=16, row_valid=jnp.asarray(row_valid),
        )
        np.testing.assert_array_equal(np.asarray(want_ok), np.asarray(got_ok))
        ok = np.asarray(want_ok)
        np.testing.assert_allclose(
            np.asarray(want)[ok], np.asarray(got)[ok], rtol=1e-12
        )

    def test_single_column_multi_equals_single(self):
        """L=1 multi must agree with the single-locus function elementwise."""
        from grid_tpu.ops.knn import d2_matrix
        from grid_tpu.ops.select import (
            dipcn_from_distances,
            dipcn_from_distances_multi,
        )

        zp, w, usable, sample_valid = self._setup(n=30, l=1, seed=2)
        d2 = d2_matrix(jnp.asarray(zp))
        got, got_ok = dipcn_from_distances_multi(
            d2, jnp.asarray(w), jnp.asarray(w), jnp.asarray(usable),
            jnp.asarray(sample_valid), k=8, n_nbr=3,
        )
        want, want_ok = dipcn_from_distances(
            d2, jnp.asarray(w[:, 0]), jnp.asarray(w[:, 0]),
            jnp.asarray(usable), jnp.asarray(sample_valid[:, 0]), k=8, n_nbr=3,
        )
        np.testing.assert_array_equal(np.asarray(got_ok)[:, 0], np.asarray(want_ok))
        ok = np.asarray(want_ok)
        np.testing.assert_allclose(
            np.asarray(got)[ok, 0], np.asarray(want)[ok], rtol=1e-12
        )
