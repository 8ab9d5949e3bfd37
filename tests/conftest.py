"""Test environment.

The platform comes from JAX_PLATFORMS: `JAX_PLATFORMS=cpu` runs the suite on
an 8-device virtual CPU platform (so sharding tests run anywhere), and the
card-only tests (`-m gpu`, tests/test_gpu_hardware.py) run with the GPU
visible. XLA_FLAGS must be set before the CPU client initializes.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # Multi-device CPU tests serialize their per-device work; with the
    # default 40 s rendezvous termination timeout, scheduling jitter can put
    # >40 s between the first and last program reaching a collective and
    # ABORT the whole pytest process. Raise it — slow is fine, aborted is
    # not.
    flags = (flags
             + " --xla_cpu_collective_call_terminate_timeout_seconds=600")
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402
import pytest  # noqa: E402

from dieselfluid_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running stress/soak tests (still in the "
        "default run; deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run with "
        "python -m pytest -m gpu tests/test_gpu_hardware.py)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev
