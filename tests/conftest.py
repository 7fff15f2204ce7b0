"""Test configuration: force the CPU backend with 8 virtual devices and fp64.

Multi-device sharding tests run on a virtual CPU mesh (the reference project's
multi-GPU paths are likewise exercised with CUDA_VISIBLE_DEVICES subsets —
SURVEY.md §4.7); fp64 is required for the machine-precision energy oracle.
Tests that need a GPU are marked `gpu` and skip unless the `gpu` fixture
finds one; run them on a GPU machine with `python -m pytest tests -m gpu`.
"""

import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from pffdtd_jax.demo import make_shoebox_room as make_shoebox  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def shoebox():
    return make_shoebox()


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is present.  The test process itself is
    pinned to the CPU, so GPU tests run their work in a child process."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
