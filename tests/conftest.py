"""Test configuration: force the CPU backend with 8 virtual devices.

Tests run on CPU (f64 available, 8 virtual devices for the distributed
tests - SURVEY.md §2.9 verified recipe). Env vars are set before jax
import AND config is updated in-process, because an exported
JAX_PLATFORMS can shadow the command-line env in some setups.

Tests that need an NVIDIA GPU are marked ``gpu`` and take the ``gpu``
fixture, which skips them when no GPU is present. Run them on a GPU host
with ``RUN_GPU_TESTS=1 python -m pytest tests/ -m gpu``: that variable
keeps this file from pinning the process to the CPU.
"""

import os

GPU_MODE = bool(os.environ.get("RUN_GPU_TESTS"))

if not GPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not GPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass
    # f64 for parity goldens (CPU only)
    jax.config.update("jax_enable_x64", True)
    # the CLI points the persistent compile cache at the checkout; keep
    # test processes from writing thousands of tiny CPU executables there
    jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def gpu_devices():
    """The GPU devices JAX sees (empty on a CPU-only host)."""
    try:
        return jax.devices("gpu")
    except RuntimeError:
        return []


def require_gpu():
    """Return the first GPU device, or skip the calling test."""
    devs = gpu_devices()
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with RUN_GPU_TESTS=1 on a "
                    "GPU host)")
    return devs[0]


@pytest.fixture
def gpu():
    """The first GPU device. Decided here, when the test runs - never at
    import or collection time - so every xdist worker collects the same
    tests."""
    return require_gpu()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables at module boundaries.

    The full suite compiles hundreds of programs (many large shard_map
    graphs on the 8-fake-device CPU client); letting them all stay live
    exhausts jaxlib's CPU compiler late in a long run (cumulative, not a
    specific test). Clearing per module keeps the live-executable count
    bounded at a small recompile cost."""
    yield
    jax.clear_caches()
