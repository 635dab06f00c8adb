"""Test configuration.

Run by pytest on its own, the suite forces the CPU platform with 8 virtual
devices, so tests are deterministic and sharding tests run without an
accelerator (the reference has no tests at all — SURVEY.md §4; jax's
host-device simulation is our 'fake backend'), and it enables float64 for
the oracles.  The environment may preset JAX_PLATFORMS (e.g. to the CUDA
plugin), so this overwrites rather than setdefaults.

A process that imported JAX before collecting the tests — ``chip_smoke.py``
running the ``gpu``-marked tests in-process on the card, since a second
process could not open it — keeps its platform and precision.
"""

import os
import sys

import pytest

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_enable_x64", True)

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The card, for ``gpu``-marked tests; skips where JAX has no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` there")
    return dev
