"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
oracle comparators flag real disagreements while passing ties."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from reference_impl import knn_np

REPO = Path(__file__).resolve().parents[1]


def test_exits_without_gpu_before_fabricating(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert res.stdout == ""  # no phase ran, no result printed


def _oracle(rng, n=40, r=6, k=5):
    z = rng.normal(size=(n, r))
    d2, idx = knn_np(z, k + 1)
    return z, d2, idx


def test_comparator_flags_planted_swap(smoke, rng):
    _, d2, idx = _oracle(rng)
    k = 5
    dev = idx[:, :k].copy()
    dev[3, k - 1] = idx[3, k]  # the (k+1)-th neighbour in place of the k-th
    gap_rel = (d2[3, k] - d2[3, k - 1]) / d2[3, k]
    assert gap_rel > 1e-5  # a real disagreement, not a tie
    agree, ties, bad = smoke.compare_neighbour_sets(dev, idx, d2, k)
    assert list(bad) == [3] and ties == 0
    assert agree.sum() == len(agree) - 1


def test_comparator_passes_tie(smoke, rng):
    _, d2, idx = _oracle(rng)
    k = 5
    d2 = d2.copy()
    d2[7, k] = d2[7, k - 1] * (1 + 1e-7)  # oracle k-th and (k+1)-th tie
    dev = idx[:, :k].copy()
    dev[7, k - 1] = idx[7, k]
    agree, ties, bad = smoke.compare_neighbour_sets(dev, idx, d2, k)
    assert bad.size == 0 and ties == 1 and not agree[7]


def _dip_case(smoke, rng, n=40, r=6, k=8, n_nbr=4):
    """A geometry whose row 0 has an exact tie at the n_nbr boundary, the
    oracle's dipCN of every row, and params naming k and n_nbr."""
    from types import SimpleNamespace

    zp = rng.normal(size=(n, r))
    _, idx = smoke.knn_oracle_rows(zp, np.arange(1), k)
    zp[idx[0, n_nbr]] = zp[idx[0, n_nbr - 1]]  # the next one now ties the last one
    row_means = rng.uniform(20, 40, size=n)
    reads = rng.uniform(500, 3000, size=n)
    geometry = (zp, row_means, np.ones(n, bool))
    rows = np.arange(n)
    ref_d2, ref_idx = smoke.knn_oracle_rows(zp, rows, k)
    w = reads / row_means
    dip = w / w[ref_idx[:, :n_nbr]].mean(axis=1)
    params = SimpleNamespace(num_neighbors=k, n_nbr=n_nbr)
    return geometry, reads, rows, ref_idx, dip, params


def test_dipcn_check_sets_aside_boundary_tie(smoke, rng):
    geometry, reads, rows, ref_idx, dip, params = _dip_case(smoke, rng)
    w = reads / geometry[1]
    other = ref_idx[0, : params.n_nbr].copy()
    other[-1] = ref_idx[0, params.n_nbr]  # the other side of the tie
    dip = dip.copy()
    dip[0] = w[0] / w[other].mean()
    smoke.check_rows_against_oracle(geometry, reads, rows, ref_idx[:, : params.num_neighbors],
                                    dip, params, "test")


def test_dipcn_check_flags_off_row(smoke, rng):
    geometry, reads, rows, ref_idx, dip, params = _dip_case(smoke, rng)
    dip = dip.copy()
    dip[5] *= 1 + 1e-3
    with pytest.raises(smoke.CheckFailed, match="dipCN rel err"):
        smoke.check_rows_against_oracle(geometry, reads, rows,
                                        ref_idx[:, : params.num_neighbors], dip, params, "test")


def test_knn_oracle_rows_matches_reference(smoke, rng):
    z = rng.normal(size=(30, 4))
    d2, idx = smoke.knn_oracle_rows(z, np.arange(30), 6)
    ref_d2, ref_idx = knn_np(z, 7)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(d2, ref_d2, rtol=1e-12, atol=1e-12)
