"""Test configuration: the platform the suite runs on.

`OPENBTS_TEST_PLATFORMS` names the JAX platforms (default "cpu"); the
CPU backend gets 8 virtual devices so the multi-device sharding is
exercised without a mesh of cards. Tests that need a GPU are marked
`gpu` and take the `gpu_device` fixture, which skips them when the
platforms hold no GPU — run them on a card with

    OPENBTS_TEST_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("OPENBTS_TEST_PLATFORMS", "cpu"))

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where the platforms hold none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (OPENBTS_TEST_PLATFORMS=cuda,cpu)")
    return gpus[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries: a single-process
    run of the whole suite otherwise accumulates hundreds of XLA-CPU
    executables, under which long runs have hit flaky compiler
    segfaults; per-module clearing keeps the compile arena small at
    the cost of cross-module cache reuse."""
    yield
    jax.clear_caches()
