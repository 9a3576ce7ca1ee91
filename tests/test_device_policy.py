"""utils/device policy units: dtype resolution, platform routing, the
compile cache, and the peak table."""

from pathlib import Path

import numpy as np
import pytest

from grid_tpu.utils.device import (
    AUTO_CPU_THRESHOLD,
    REPO_CACHE_DIR,
    enable_compilation_cache,
    resolve_dtype,
    step_device,
)


def test_resolve_dtype():
    assert resolve_dtype(None) is None
    assert resolve_dtype({"device": {"dtype": "auto"}}) is None
    assert resolve_dtype({"device": {"dtype": "float32"}}) == np.float32
    assert resolve_dtype({"device": {"dtype": "f64"}}) == np.float64
    import jax.numpy as jnp

    assert resolve_dtype({"device": {"dtype": "bf16"}}) == jnp.bfloat16
    with pytest.raises(ValueError, match="unknown device.dtype"):
        resolve_dtype({"device": {"dtype": "int7"}})


def test_step_device_routing():
    import jax

    # on the CPU test backend, both branches yield cpu, but the chosen label
    # must follow the policy
    with step_device({"device": {"platform": "cpu"}}, 10**9) as plat:
        assert plat == "cpu"
    with step_device(None, 1) as plat:
        # auto + tiny workload: cpu when an accelerator is default, else the
        # backend name (cpu in tests)
        assert plat == jax.default_backend()
    with step_device({"device": {"platform": "default"}}, 1) as plat:
        assert plat == jax.default_backend()


def test_auto_threshold_positive():
    assert AUTO_CPU_THRESHOLD > 0


def test_step_device_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="'gpu' but JAX's default backend is 'cpu'"):
        with step_device({"device": {"platform": "gpu"}}, 10**9):
            pass


def test_step_device_rejects_unknown_platform():
    with pytest.raises(ValueError, match="unknown device.platform 'xpu'"):
        with step_device({"device": {"platform": "xpu"}}, 1):
            pass


def test_step_device_logs_placement(caplog):
    import logging

    with caplog.at_level(logging.INFO, logger="grid_tpu.utils.device"):
        with step_device({"device": {"platform": "cpu"}}, 7):
            pass
    (rec,) = caplog.records
    assert rec.args == ("cpu", 7)
    assert rec.funcName == "test_step_device_logs_placement"  # the calling step


@pytest.fixture
def cache_config():
    """Restore jax's compile-cache settings after a test changes them."""
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield jax.config
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_follows_env_var(monkeypatch, tmp_path, cache_config):
    before = cache_config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert enable_compilation_cache() == tmp_path / "jc"
    # JAX reads its own variable; the code sets no directory of its own
    assert cache_config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == REPO_CACHE_DIR
    assert cache_config.jax_compilation_cache_dir == str(REPO_CACHE_DIR)
    assert REPO_CACHE_DIR.is_dir()
    assert REPO_CACHE_DIR.parent == Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "kind, want",
    [
        ("NVIDIA H100 80GB HBM3", {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}),
        ("NVIDIA A100-SXM4-80GB", None),
        ("cpu", None),
    ],
)
def test_peak_table(kind, want):
    from grid_tpu.utils.peaks import peak_for

    got = peak_for(kind)
    if want is None:
        assert got is None  # never a borrowed peak
    else:
        assert {k: got[k] for k in want} == want
        assert got["bf16_flops"] == 989e12 and got["tf32_flops"] == 495e12
