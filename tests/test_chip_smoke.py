"""chip_smoke.py: it refuses to run without a GPU, fails outside the repo,
and its phases run end to end at small sizes on CPU devices (the GPU runs
them at full size; see tests/test_gpu.py)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from cubicsdr.ops.planar import PLANAR
from cubicsdr.receiver import DemodGroupSpec, ReceiverPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    return any(ln.startswith('{"ok"') for ln in stdout.splitlines())


def test_refuses_cpu_only_run():
    r = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


@pytest.fixture(scope="module")
def farm_len():
    m = ReceiverPipeline(cs.FS, [DemodGroupSpec("FM", 200000, 1)],
                         num_channels=cs.NUM_CHANNELS,
                         dtype=PLANAR).group_block_multiple(0)
    return 8 * m


def test_farm_freqs_stay_clear_of_the_wrap():
    f = cs.farm_freqs(256)
    assert abs(f).max() + 100e3 < cs.FS / 2
    assert len(set(f.tolist())) == 15


def test_flagship_phase_on_cpu_devices(farm_len):
    cpus = jax.devices("cpu")
    cs.phase_flagship(cpus[1], cpus[0], seed=3, n_blocks=2,
                      block_len=farm_len, timed_blocks=1, big=32)


def test_kernels_phase_on_cpu_devices(farm_len):
    cpus = jax.devices("cpu")
    cs.phase_kernels(cpus[1], cpus[0], seed=3, block_len=farm_len,
                     n_demods=32)


def test_four_cards_phase_on_cpu_devices(farm_len):
    cs.phase_four_cards(jax.devices("cpu")[:4], seed=3, n_demods=8,
                        n_blocks=2, target_len=4 * farm_len)


def test_cli_phase_on_cpu():
    cs.phase_cli(seconds=0.5)
