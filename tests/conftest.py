"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip logic (TP/DP sharding) is tested without TPUs via
``--xla_force_host_platform_device_count`` (SURVEY §4): the same jit +
NamedSharding code paths compile and execute on host devices.
"""

import os

# Must be set before the first jax backend use.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["QWEN3_TPU_DISABLE_PALLAS"] = "1"
# Keep tests hermetic: the CLI enables the persistent XLA compilation cache
# (utils/compile_cache.py) in-process, and on this machine cache entries may
# have been produced by a remote-compile service targeting a different x86
# feature set — loading those AOT artifacts into the test process triggers
# "machine type doesn't match" warnings and can mis-execute (SIGILL class).
os.environ["QWEN3_TPU_NO_COMPILE_CACHE"] = "1"

import jax  # noqa: E402

# Force the CPU backend even when a TPU plugin was registered at interpreter
# startup (site customization may pre-set jax_platforms): the config update
# wins as long as no backend has been initialized yet.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); skips without one"
    )
