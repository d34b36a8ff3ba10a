"""On-card checks: the same functions chip_smoke.py runs, at full size,
with a GPU as the device under test and the CPU backend as reference.

Run them on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu

Elsewhere every test here skips (the ``gpu_device`` fixture decides)."""

import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_flagship_on_gpu(gpu_device):
    cs.phase_flagship(gpu_device, jax.devices("cpu")[0], seed=0)


def test_fidelity_on_gpu(gpu_device):
    cs.phase_fidelity(gpu_device, jax.devices("cpu")[0], seed=0)


def test_route_and_channelizer_on_gpu(gpu_device):
    cs.phase_kernels(gpu_device, jax.devices("cpu")[0], seed=0)


def test_live_loop_on_gpu(gpu_device):
    cs.phase_live(gpu_device, seed=0)
