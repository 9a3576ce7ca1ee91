"""Iterative haplotype copy-number inference (pipeline step 7).

Accelerator re-design of the reference's phasing loop
(``grid/utils/hi_inference.py:175-250``; math
``docs/source/algorithms/hi_inference.rst:55-93``): the ragged per-haplotype
neighbor lists become padded ``[2N, MAX_NBR]`` index/weight arrays, and the
n_iters sweep becomes a ``lax.scan`` of fully-vectorized updates.

Ordering caveat (SURVEY §3.4): the reference updates ``hap_IRRs`` in place
while iterating samples (Gauss-Seidel), so later samples see earlier samples'
new values within one iteration. The vectorized device update is Jacobi; both
share fixed points and at n_iters=100 agree to statistical tolerance.
``phase_gauss_seidel_host`` reproduces the reference ordering bit-for-bit for
small-cohort parity testing and an opt-in "exact" pipeline mode.

The 1e-9 weight-sum floor is preserved so padded/empty neighbor sets fall
back exactly like the reference's (grid/utils/hi_inference.py:209).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PhasingResult(NamedTuple):
    """Outputs of :func:`phase_haplotypes`.

    Attributes:
        hap_irrs: [2N] final haplotype values (NaN for unphased samples);
            sample i's haplotypes are rows 2i and 2i+1.
        mean_irrs: scalar mean diploid IRR over phased samples (0 if none).
        phased: [N] bool — both haplotypes had >= min_nbr neighbors.
    """

    hap_irrs: jnp.ndarray
    mean_irrs: jnp.ndarray
    phased: jnp.ndarray


def _neighbor_means(hap_irrs, nbr_idx, nbr_w, nbr_valid):
    """Weighted mean of non-NaN neighbor values per haplotype row.

    Returns (means [2N], contrib_wsum [2N]) where means use the reference's
    1e-9 floor: mean = sum(w*val) / (1e-9 + sum(w)) over usable neighbors.
    """
    val = hap_irrs[nbr_idx]  # [2N, K]
    ok = nbr_valid & ~jnp.isnan(val)
    wsum = jnp.sum(jnp.where(ok, nbr_w, 0), axis=1)
    wval = jnp.sum(jnp.where(ok, nbr_w * val, 0), axis=1)
    floor = jnp.asarray(1e-9, dtype=hap_irrs.dtype)
    return wval / (floor + wsum), wsum


@partial(jax.jit, static_argnames=("min_nbr", "n_iters"))
def phase_haplotypes(irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int) -> PhasingResult:
    """Run the iterative phasing to n_iters (Jacobi ordering).

    Args:
        irrs: [N] diploid IRR (dipCN) per sample.
        nbr_idx: [2N, K] neighbor haplotype-row indices (padding -> 0).
        nbr_w: [2N, K] neighbor weights (padding -> 0).
        nbr_valid: [2N, K] bool padding mask.
        min_nbr: both haplotypes need >= min_nbr neighbors to participate.
        n_iters: number of sweeps (reference default 100).
    """
    irrs = jnp.asarray(irrs)
    nbr_valid = jnp.asarray(nbr_valid, dtype=bool)
    n = irrs.shape[0]

    deg = jnp.sum(nbr_valid, axis=1).reshape(n, 2)  # per-sample [h0, h1]
    # Samples with a non-finite IRR correspond to rows absent from the
    # reference's dipCN file — they never enter phasing there, so exclude
    # them here (prevents NaN poisoning mean_irrs in the fused path).
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & jnp.isfinite(irrs)

    hap0 = jnp.where(phased, irrs / 2, jnp.nan)
    hap_irrs = jnp.stack([hap0, hap0], axis=1).reshape(2 * n)

    irr_rep = jnp.repeat(irrs, 2)

    def sweep(hap, _):
        means, _ = _neighbor_means(hap, nbr_idx, nbr_w, nbr_valid)
        m = means.reshape(n, 2)
        denom = m[:, 0] + m[:, 1]
        new = (irr_rep * means) / jnp.repeat(denom, 2)
        keep_old = jnp.repeat(denom <= 0, 2) | jnp.isnan(hap)
        return jnp.where(keep_old, hap, new), None

    hap_irrs, _ = jax.lax.scan(sweep, hap_irrs, None, length=n_iters)

    n_phased = jnp.sum(phased)
    mean_irrs = jnp.where(n_phased > 0, jnp.sum(jnp.where(phased, irrs, 0)) / jnp.maximum(n_phased, 1), 0.0)
    return PhasingResult(hap_irrs=hap_irrs, mean_irrs=mean_irrs, phased=phased)


@jax.jit
def compute_imputed(hap_irrs, nbr_idx, nbr_w, nbr_valid, mean_irrs):
    """Final-iteration imputation columns (ref: grid/utils/hi_inference.py:229-250).

    Per haplotype: the weighted neighbor mean, falling back to
    ``mean_irrs / 2`` when no phased neighbor contributed (weight sum at the
    1e-9 floor).

    Returns imp: [2N].
    """
    means, wsum = _neighbor_means(jnp.asarray(hap_irrs), nbr_idx, nbr_w, nbr_valid)
    return jnp.where(wsum > 0, means, mean_irrs / 2)


# ----------------------------------------------------------------- host ---


def phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr: int, n_iters: int):
    """Bit-exact reference-ordered phasing on the host
    (mirrors grid/utils/hi_inference.py:175-226 semantics: in-place updates,
    Python float64 arithmetic, sequential accumulation order).

    Args:
        irrs: sequence of N diploid IRRs.
        hap_nbrs: ragged list (length 2N) of (neighbor_hap_idx, weight).

    Returns (hap_irrs list[2N], mean_irrs float, phased list[N] bool).
    """
    n = len(irrs)
    hap_irrs = [float("nan")] * (2 * n)
    phased = [False] * n

    n_to_phase = 0
    mean_irrs = 0.0
    for i in range(n):
        if len(hap_nbrs[2 * i]) >= min_nbr and len(hap_nbrs[2 * i + 1]) >= min_nbr:
            hap_irrs[2 * i] = irrs[i] / 2
            hap_irrs[2 * i + 1] = irrs[i] / 2
            phased[i] = True
            n_to_phase += 1
            mean_irrs += irrs[i]
    if n_to_phase > 0:
        mean_irrs /= n_to_phase

    for _ in range(n_iters):
        for i in range(n):
            if math.isnan(hap_irrs[2 * i]):
                continue
            wsum = [1e-9, 1e-9]
            wval = [0.0, 0.0]
            for h in range(2):
                for nbr, w in hap_nbrs[2 * i + h]:
                    val = hap_irrs[nbr]
                    if not math.isnan(val):
                        wsum[h] += w
                        wval[h] += w * val
            m0 = wval[0] / wsum[0]
            m1 = wval[1] / wsum[1]
            denom = m0 + m1
            if denom > 0:
                hap_irrs[2 * i] = irrs[i] * m0 / denom
                hap_irrs[2 * i + 1] = irrs[i] * m1 / denom

    return hap_irrs, mean_irrs, phased


def compute_imputed_host(i, hap_irrs, hap_nbrs, mean_irrs):
    """Host imputation for sample i (mirrors grid/utils/hi_inference.py:229-250)."""
    wsum = [1e-9, 1e-9]
    wval = [0.0, 0.0]
    for h in range(2):
        for nbr, w in hap_nbrs[2 * i + h]:
            val = hap_irrs[nbr]
            if not math.isnan(val):
                wsum[h] += w
                wval[h] += w * val
    imp0 = wval[0] / wsum[0]
    imp1 = wval[1] / wsum[1]
    if wsum[0] <= 1e-9:
        imp0 = mean_irrs / 2
    if wsum[1] <= 1e-9:
        imp1 = mean_irrs / 2
    return imp0, imp1


# ------------------------------------------------------------- bootstrap ---


@partial(jax.jit, static_argnames=("min_nbr", "n_iters", "n_boot"))
def phase_bootstrap(key, irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int,
                    n_boot: int = 100):
    """Bootstrap uncertainty for the haplotype estimates, vmapped over
    replicates (the accelerator answer to "how stable is this phasing?").

    Each replicate resamples every haplotype's neighbor list with
    replacement (within its own valid slots — pad_hap_neighbors stores valid
    entries as a prefix, so slot j < degree is always a real neighbor) and
    reruns the full n_iters phasing. All replicates execute as ONE vmapped
    program: the sweep's gathers and reductions batch across the replicate
    axis, so B bootstraps cost barely more than one.

    Args:
        key: jax PRNG key.
        (rest as :func:`phase_haplotypes`)
        n_boot: number of bootstrap replicates.

    Returns:
        hap_mean: [2N] mean over replicates (NaN where never phased).
        hap_std: [2N] standard deviation over replicates.
        hap_boot: [n_boot, 2N] raw replicate estimates.
    """
    irrs = jnp.asarray(irrs)
    nbr_idx = jnp.asarray(nbr_idx)
    nbr_w = jnp.asarray(nbr_w)
    nbr_valid = jnp.asarray(nbr_valid, dtype=bool)
    deg = jnp.sum(nbr_valid, axis=1)  # [2N]

    def one(k):
        slots = jax.random.randint(
            k, nbr_idx.shape, 0, jnp.maximum(deg, 1)[:, None]
        )
        bi = jnp.take_along_axis(nbr_idx, slots, axis=1)
        bw = jnp.take_along_axis(nbr_w, slots, axis=1)
        # validity (and thus the min_nbr gate) is degree-preserving
        res = phase_haplotypes(irrs, bi, bw, nbr_valid, min_nbr, n_iters)
        return res.hap_irrs

    keys = jax.random.split(key, n_boot)
    hap_boot = jax.vmap(one)(keys)  # [B, 2N]
    return jnp.mean(hap_boot, axis=0), jnp.std(hap_boot, axis=0), hap_boot
