"""grid_tpu — an accelerator (JAX) framework for haplotype-resolved VNTR
copy-number inference from binned WGS coverage.

A from-scratch re-design (not a port) of the capabilities of GRiD. The cohort depth matrix (samples x genome bins)
lives as a sharded ``jnp`` array over a ``jax.sharding.Mesh``; normalization,
nearest-neighbor search, diploid CN estimation and iterative haplotype
phasing are pure, jittable functions composed into one fused device step,
with XLA collectives (psum / all_gather / ppermute) carrying cross-host work.

Layering (bottom to top):

- :mod:`grid_tpu.ops`       — core numerical kernels (masked stats, kNN,
                              dipCN, phasing) as jittable functions.
- :mod:`grid_tpu.models`    — the flagship fused cohort pipeline model.
- :mod:`grid_tpu.parallel`  — mesh construction, sharded cohort statistics,
                              ring/all-gather distributed kNN.
- :mod:`grid_tpu.io`        — reference-compatible on-disk formats.
- :mod:`grid_tpu.ingest`    — CPU-side CRAM/BAM/mosdepth ingestion feeding
                              host buffers (native C++ fast paths).
- :mod:`grid_tpu.steps`     — the seven pipeline steps (config-driven).
- :mod:`grid_tpu.pipeline`  — orchestrator; :mod:`grid_tpu.cli` — CLI.

Quick start (library use):

    from grid_tpu.models import cohort_step, CohortParams
    out = cohort_step(values, mask, reads, reads_valid, hi, hw, hv,
                      CohortParams(num_neighbors=500))

    from grid_tpu.pipeline import run_wgs_pipeline
    run_wgs_pipeline(config="config.yaml")
"""

__version__ = "0.6.0"

from grid_tpu import ops  # noqa: F401


def run_wgs_pipeline(*args, **kwargs):
    """Convenience re-export of :func:`grid_tpu.pipeline.run_wgs_pipeline`."""
    from grid_tpu.pipeline import run_wgs_pipeline as _run

    return _run(*args, **kwargs)


__all__ = ["ops", "run_wgs_pipeline", "__version__"]
