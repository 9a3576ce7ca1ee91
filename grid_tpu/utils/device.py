"""Device selection and compilation-cache policy.

Two production concerns the reference never had:

- **Compile latency**: XLA compiles each (shape, fn) once per process. A
  persistent compilation cache makes re-runs and resumes skip the compile.
- **Tiny workloads**: a locus-restricted cohort matrix can be a few KB —
  dispatching it to an accelerator buys nothing and pays compile+transfer.
  ``step_device`` places step math on CPU below a size threshold (the
  ``device.platform: auto`` policy), on the accelerator above it.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager
from pathlib import Path

# Workloads below this many matrix elements run on CPU under "auto".
AUTO_CPU_THRESHOLD = int(os.environ.get("GRID_TPU_AUTO_CPU_THRESHOLD", 2_000_000))

PLATFORMS = ("auto", "cpu", "gpu", "default")

# The compile cache's home when JAX_COMPILATION_CACHE_DIR is unset: one fixed
# path inside the checkout (the path is part of the cache key, so it must
# not move between runs).
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_log = logging.getLogger(__name__)


def enable_compilation_cache() -> Path:
    """Enable the persistent XLA compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache goes to ``REPO_CACHE_DIR``.
    A directory that cannot be created raises.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        cache_dir = Path(env_dir)
    else:
        cache_dir = REPO_CACHE_DIR
        cache_dir.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def resolve_dtype(config: dict | None):
    """Map device.dtype to a numpy/jnp dtype, or None for "auto" (keep the
    staged arrays' dtype: float64 on the x64 CPU backend, float32 on GPU)."""
    import numpy as np

    name = "auto"
    if config:
        name = str(config.get("device", {}).get("dtype", "auto")).lower()
    if name in ("auto", "none", ""):
        return None
    import jax.numpy as jnp

    table = {
        "float32": np.float32,
        "f32": np.float32,
        "float64": np.float64,
        "f64": np.float64,
        "bfloat16": jnp.bfloat16,
        "bf16": jnp.bfloat16,
    }
    if name not in table:
        raise ValueError(f"unknown device.dtype {name!r}")
    return table[name]


@contextmanager
def step_device(config: dict | None, workload_elems: int):
    """Context manager placing jax computations for one pipeline step.

    ``device.platform`` config values:
        - "auto" (default): CPU when workload_elems < AUTO_CPU_THRESHOLD,
          default accelerator otherwise;
        - "cpu": always host;
        - "gpu": the default backend, which must be a GPU (raises otherwise,
          so no step quietly runs elsewhere);
        - "default": leave placement alone.

    Yields the platform the step runs on, and logs it (logger
    ``grid_tpu.utils.device``, INFO, attributed to the calling step).
    """
    import jax

    platform = "auto"
    if config:
        platform = str(config.get("device", {}).get("platform", "auto")).lower()
    if platform not in PLATFORMS:
        raise ValueError(f"unknown device.platform {platform!r}; expected one of {PLATFORMS}")
    if platform == "gpu" and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"device.platform is 'gpu' but JAX's default backend is {jax.default_backend()!r}"
        )

    use_cpu = platform == "cpu" or (
        platform == "auto"
        and workload_elems < AUTO_CPU_THRESHOLD
        and jax.default_backend() != "cpu"
    )
    placed = "cpu" if use_cpu else jax.default_backend()
    # stacklevel 3: past contextlib's __enter__ to the step that asked
    _log.info("step placed on %s (%d elements)", placed, workload_elems, stacklevel=3)
    if use_cpu:
        with jax.default_device(jax.devices("cpu")[0]):
            yield placed
    else:
        yield placed
