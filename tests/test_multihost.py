"""REAL multi-process DCN ingest (SURVEY §2.11): two OS processes join via
jax.distributed.initialize (gloo over loopback standing in for DCN), each
supplies only its own time-span of every block through shard_iq_local, and
every output's addressable shards are verified in-worker against the
unsharded ReceiverPipeline. This is the evidence that the multi-host claim
does not rest on a process_count()==1 identity check."""

import subprocess
import sys

from cubicsdr.parallel import multihost


def test_two_process_dcn_ingest():
    reports = multihost.launch_local(num_processes=2, steps=2,
                                     devices_per_process=4)
    assert len(reports) == 2
    for rep in reports:
        assert rep["ok"] and rep["verified"]
        assert rep["process_count"] == 2      # a real 2-process job
        assert rep["local_devices"] == 4
        assert rep["global_devices"] == 8


def test_cli_worker_flags_exist():
    # The path must be drivable from the shell (cubicsdr multihost).
    r = subprocess.run([sys.executable, "-m", "cubicsdr",
                        "multihost", "--help"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0
    for flag in ("--worker", "--coordinator", "--process-id", "--nprocs"):
        assert flag in r.stdout
