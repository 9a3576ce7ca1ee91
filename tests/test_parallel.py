"""Multi-device tests on the virtual 8-CPU mesh: sharded stats, ring kNN,
and the full sharded cohort step vs the single-device fused step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grid_tpu.models.cohort import CohortParams, cohort_step
from grid_tpu.ops.knn import knn_squared
from grid_tpu.ops.normalize import normalize_cohort
from grid_tpu.parallel import (
    cohort_mesh,
    normalize_cohort_sharded,
    ring_knn,
    sharded_cohort_step,
    auto_sharded_cohort_step,
)
from grid_tpu.parallel.mesh import shard_cohort_inputs
from grid_tpu.io.hap_neighbors import pad_hap_neighbors


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _cohort_data(rng, n, r):
    values = rng.uniform(20, 60, size=(n, r))
    mask = rng.random((n, r)) > 0.1
    return values * mask, mask


@requires_multidevice
def test_sharded_normalize_matches_single(rng):
    n, r = 48, 33
    values, mask = _cohort_data(rng, n, r)
    mesh = cohort_mesh(8)

    ref = normalize_cohort(values, mask)
    res = normalize_cohort_sharded(
        jax.device_put(values), jax.device_put(mask), mesh
    )

    np.testing.assert_allclose(np.asarray(res.col_means), np.asarray(ref.col_means), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res.col_vars), np.asarray(ref.col_vars), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res.var_ratio), np.asarray(ref.var_ratio), rtol=1e-12)
    np.testing.assert_allclose(float(res.scale), float(ref.scale), rtol=1e-12)
    zs, zr = np.asarray(res.z), np.asarray(ref.z)
    ms = np.asarray(res.mask)
    np.testing.assert_allclose(zs[ms], zr[ms], rtol=1e-10)


@requires_multidevice
def test_ring_knn_matches_single(rng):
    n, r, k = 64, 12, 7
    z = rng.normal(size=(n, r))
    mesh = cohort_mesh(8)

    ref_d, ref_i = knn_squared(jnp.asarray(z), k, row_block=16)
    d, i = ring_knn(jax.device_put(jnp.asarray(z)), k, mesh)

    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), rtol=1e-9, atol=1e-9)
    for row in range(n):
        assert set(np.asarray(i)[row].tolist()) == set(np.asarray(ref_i)[row].tolist())


@requires_multidevice
def test_ring_knn_respects_row_valid(rng):
    n, r, k = 40, 6, 5
    z = rng.normal(size=(n, r))
    valid = np.ones(n, dtype=bool)
    valid[30:] = False  # padding tail
    mesh = cohort_mesh(8)
    d, i = ring_knn(jnp.asarray(z), k, mesh, row_valid=jnp.asarray(valid))
    assert (np.asarray(i)[:30] < 30).all()


@requires_multidevice
def test_sharded_cohort_step_matches_fused(rng):
    n, r = 22, 30  # deliberately NOT divisible by 8 — exercises padding
    values, mask = _cohort_data(rng, n, r)
    reads = rng.integers(500, 2000, size=n).astype(float)
    reads_valid = np.ones(n, dtype=bool)
    hap_nbrs = [
        [((h + 2) % (2 * n), 1.0), ((h + 5) % (2 * n), 0.7)] for h in range(2 * n)
    ]
    hi, hw, hv = pad_hap_neighbors(hap_nbrs, 2, dtype=np.float64)
    params = CohortParams(num_neighbors=6, n_nbr=6, n_iters=40, row_block=8)

    ref = cohort_step(
        values, mask, reads, reads_valid, hi, hw, hv, params
    )
    mesh = cohort_mesh(8)
    res = sharded_cohort_step(mesh, values, mask, reads, reads_valid, hi, hw, hv, params)

    np.testing.assert_allclose(float(res.r_use), float(ref.r_use))
    ref_dip, ref_ok = np.asarray(ref.dipcn), np.asarray(ref.dipcn_valid)
    res_dip, res_ok = np.asarray(res.dipcn)[:n], np.asarray(res.dipcn_valid)[:n]
    assert (ref_ok == res_ok).all()
    np.testing.assert_allclose(res_dip[res_ok], ref_dip[ref_ok], rtol=1e-9)
    # phasing identical (same dipCN input)
    rh, sh = np.asarray(ref.hap_irrs), np.asarray(res.hap_irrs)
    nanmask = np.isnan(rh)
    assert (nanmask == np.isnan(sh)).all()
    np.testing.assert_allclose(sh[~nanmask], rh[~nanmask], rtol=1e-9)


@requires_multidevice
def test_sharded_cohort_step_gather_form_matches(rng):
    """payload_ring=False (the r2 replicated-gather measurement knob)
    selects the same neighbors and produces the same dipCN."""
    n, r = 22, 30
    values, mask = _cohort_data(rng, n, r)
    reads = rng.integers(500, 2000, size=n).astype(float)
    reads_valid = np.ones(n, dtype=bool)
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 1)
    params = CohortParams(num_neighbors=6, n_nbr=6, n_iters=0, row_block=8)

    mesh = cohort_mesh(8)
    ring = sharded_cohort_step(
        mesh, values, mask, reads, reads_valid, hi, hw, hv, params
    )
    gat = sharded_cohort_step(
        mesh, values, mask, reads, reads_valid, hi, hw, hv, params,
        payload_ring=False,
    )
    a_ok = np.asarray(ring.dipcn_valid)[:n]
    b_ok = np.asarray(gat.dipcn_valid)[:n]
    assert (a_ok == b_ok).all()
    np.testing.assert_allclose(
        np.asarray(gat.dipcn)[:n][b_ok], np.asarray(ring.dipcn)[:n][a_ok],
        rtol=1e-9,
    )


@requires_multidevice
def test_auto_sharded_cohort_step_runs(rng):
    n, r = 32, 16
    values, mask = _cohort_data(rng, n, r)
    reads = rng.integers(500, 2000, size=n).astype(float)
    reads_valid = np.ones(n, dtype=bool)
    hap_nbrs = [[((h + 2) % (2 * n), 1.0)] for h in range(2 * n)]
    hi, hw, hv = pad_hap_neighbors(hap_nbrs, 1, dtype=np.float64)
    params = CohortParams(num_neighbors=4, n_nbr=4, n_iters=10, row_block=8)

    mesh = cohort_mesh(8)
    vals, msk, rds, rdv, rv = shard_cohort_inputs(mesh, values, mask, reads, reads_valid)
    # hap arrays sized for padded N
    n_pad = vals.shape[0]
    hap_nbrs_p = hap_nbrs + [[] for _ in range(2 * (n_pad - n))]
    hi_p, hw_p, hv_p = pad_hap_neighbors(hap_nbrs_p, 1, dtype=np.float64)

    step = auto_sharded_cohort_step(mesh, params)
    out = step(vals, msk, rds, rdv, jnp.asarray(hi_p), jnp.asarray(hw_p), jnp.asarray(hv_p), rv)

    ref = cohort_step(values, mask, reads, reads_valid, hi, hw, hv, params)
    ref_dip, ref_ok = np.asarray(ref.dipcn), np.asarray(ref.dipcn_valid)
    out_dip, out_ok = np.asarray(out.dipcn)[:n], np.asarray(out.dipcn_valid)[:n]
    assert (ref_ok == out_ok).all()
    np.testing.assert_allclose(out_dip[out_ok], ref_dip[ref_ok], rtol=1e-9)


def test_ring_knn_never_materializes_wide_panels():
    """Structure canary for the ring merge: no intermediate in the ring
    kernel may have a column dimension of N (the gathered width) — the
    merge must stay O(B * (k + B)) per step. Catches an accidental
    all-gather / [B, N] concat regression at trace time, where wall-clock
    CI timing cannot."""
    import jax
    import jax.numpy as jnp

    from grid_tpu.parallel.mesh import cohort_mesh
    from grid_tpu.parallel.pknn import ring_knn

    n, r, k = 4096, 64, 32
    mesh = cohort_mesh(8)
    b = n // 8

    z = jnp.zeros((n, r), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda zz: ring_knn(zz, k, mesh))(z)

    def shapes(jx, acc):
        for eqn in jx.eqns:
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if aval is not None and getattr(aval, "shape", None):
                    acc.append(tuple(aval.shape))
            for sub in eqn.params.values():
                if hasattr(sub, "jaxpr"):
                    shapes(sub.jaxpr if hasattr(sub.jaxpr, "eqns") else sub, acc)
        return acc

    all_shapes = shapes(jaxpr.jaxpr, [])
    # anything with a trailing dim >= 2*B + k inside the kernel would mean a
    # gathered-width merge (the global result [n, k] itself is fine)
    wide = [s for s in all_shapes if len(s) == 2 and s[0] in (b, n)
            and s[1] > 2 * b + k and s[1] != r]
    assert not wide, f"ring kernel materializes wide panels: {wide}"


class TestDispatchPolicy:
    """The flat-vs-ring crossover (parallel/policy.py, from the CPU mesh
    sweep) is CODE, not folklore: a configured mesh must not make a small
    cohort pay for the ring."""

    def test_crossover_brackets_match_measurements(self):
        from grid_tpu.parallel.policy import choose_cohort_execution

        # measured: flat wins at 8,192; ring wins at 32,768 (8-dev mesh)
        assert choose_cohort_execution(8_192, 8) == "flat"
        assert choose_cohort_execution(32_768, 8) == "ring"

    def test_single_device_always_flat(self):
        from grid_tpu.parallel.policy import choose_cohort_execution

        assert choose_cohort_execution(1_000_000, 1) == "flat"

    def test_forced_dispatch(self):
        import pytest

        from grid_tpu.parallel.policy import choose_cohort_execution

        assert choose_cohort_execution(100, 8, "ring") == "ring"
        assert choose_cohort_execution(100_000, 8, "flat") == "flat"
        with pytest.raises(ValueError):
            choose_cohort_execution(100, 8, "fastest")
        with pytest.raises(ValueError):
            choose_cohort_execution(100, 1, "ring")

    def test_fused_step_routes_small_mesh_cohort_flat(self, tmp_path, monkeypatch):
        """A 12-sample cohort with device.mesh_shape=[8] must run the
        single-device step: the sharded path is patched to explode."""
        import copy

        import grid_tpu.steps.fused as fused_mod
        from grid_tpu.pipeline import run_wgs_pipeline
        from grid_tpu.synth import make_synthetic_cohort

        def boom(*a, **k):  # pragma: no cover - failure path
            raise AssertionError("ring path taken below crossover")

        # fused.py resolves the symbol from the package at call time
        monkeypatch.setattr("grid_tpu.parallel.sharded_cohort_step", boom)
        cohort = make_synthetic_cohort(tmp_path, n_samples=12, seed=3)
        cfg = copy.deepcopy(cohort["config"])
        cfg["device"] = {"fused": True, "mesh_shape": [8]}
        (tmp_path / "results" / "read_counts.tsv").write_bytes(
            cohort["counts_file"].read_bytes()
        )
        run_wgs_pipeline(console=None, config=cfg)
        assert (tmp_path / "results" / "diploid_genotypes.tsv").exists()


def test_ring_knn_payload_carry():
    """Payloads carried through the ring must equal gathering the payload
    vector at the returned neighbor indices — the gather-free dipCN
    contract for the sharded path."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grid_tpu.parallel import cohort_mesh
    from grid_tpu.parallel.pknn import ring_knn

    mesh = cohort_mesh(8)
    n, r, k = 64, 12, 9
    rng = np.random.default_rng(7)
    z = np.round(rng.normal(size=(n, r)).astype(np.float32) * 4) / 4
    w = rng.uniform(0.1, 3.0, n).astype(np.float32)
    usable = rng.random(n) > 0.25
    valid = np.ones(n, bool)
    valid[-3:] = False  # padding rows

    d, idx, cw, cu = ring_knn(
        jnp.asarray(z), k, mesh, row_valid=jnp.asarray(valid),
        payloads=(jnp.asarray(w), jnp.asarray(usable)),
    )
    d, idx, cw, cu = map(np.asarray, (d, idx, cw, cu))
    np.testing.assert_array_equal(cw, w[idx])
    np.testing.assert_array_equal(cu, usable[idx])
    # and no invalid row ever appears as a neighbor
    assert valid[idx].all()
