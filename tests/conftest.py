"""Shared fixtures. NOTE: no XLA_FLAGS here — unit tests must see the real
single CPU device; multi-device tests spawn subprocesses with their own
--xla_force_host_platform_device_count (tests/_subproc.py)."""

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper GPU (CUDA kernels); skipped without one")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _isolate_autotune_cache(tmp_path, monkeypatch):
    """Point the kernel block autotuner at a per-test cache file so tests
    never read or pollute the user-level ~/.cache/repro/autotune.json."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
