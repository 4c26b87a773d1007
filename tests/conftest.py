"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Sharding/halo-exchange tests run on XLA's host-platform device
virtualization. ``PS_TEST_PLATFORM`` overrides the platform list — the
card-only tests (``-m gpu``, tests/test_gpu_hw.py) run with
``PS_TEST_PLATFORM=cuda,cpu`` (the GPU first, so it is JAX's default device;
the CPU beside it for the engine's CPU device choices).
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = os.environ.get("PS_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# a pytest plugin may have imported jax before this file ran, and jax reads
# JAX_PLATFORMS only at import: pin the platform through jax.config as well
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run with "
        "PS_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu tests/test_gpu_hw.py)",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, so every xdist worker collects the same tests."""
    from particle_simulator_tpu.engine.platform import accelerator

    device = accelerator()
    if device is None:
        pytest.skip("no GPU: card-only test")
    return device
