"""Test harness.

Unit tests run on the CPU backend unless ``JAX_PLATFORMS`` says otherwise,
with a virtual 8-device CPU mesh configured BEFORE jax import so
channel/time sharding and halo exchange are testable on one host
(SURVEY.md §4 item 4). Tests that need a GPU carry the ``gpu`` marker and
skip, from the ``gpu_device`` fixture, when JAX finds none.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The entry points turn on JAX's persistent compile cache; tests compile
# many small programs and keep that cache off.
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest tests/test_gpu.py -m gpu` on a machine with one")
    return gpus[0]


def make_tone(n, freq, fs, amp=1.0, phase=0.0):
    t = np.arange(n) / fs
    return (amp * np.exp(2j * np.pi * freq * t + 1j * phase)).astype(
        np.complex64)


@pytest.fixture
def tone():
    return make_tone
