"""Multi-host (DCN) distributed receive — a REAL multi-process run.

SURVEY §2.11's inter-host story: each host ingests ONLY its own time-span
of every IQ block (its local SDR / socket sources), the global sharded
array is assembled with ``jax.make_array_from_process_local_data`` (no host
ever gathers raw samples), and the compiled ``ShardedReceiver`` step's
collectives are the only traffic DCN carries. This module makes that path
*drivable*:

  * ``run_worker``    — one process of an N-process receive job. Call via
                        ``cubicsdr multihost --worker ...`` (the CLI
                        sets the env before JAX import) or directly, one
                        process per host, with the coordinator's address.
  * ``launch_local``  — demo/test launcher: spawns N CPU worker processes
                        on localhost (gloo collectives over loopback
                        standing in for DCN) and returns their reports.

The reference has no multi-host analog (single desktop process; its only
networking is SoapyRemote device streaming, src/CubicSDR.cpp:614-622) —
this is the distributed answer to "the SDR is somewhere else":
N ingest hosts, one compiled receive fleet.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

# Keep the demo job small: CPU workers compile in seconds and the test
# suite runs the whole 2-process job under pytest.
DEMO_FS = 1_000_000.0
DEMO_CHANNELS = 8


def _demo_groups():
    from cubicsdr.receiver import DemodGroupSpec
    return [DemodGroupSpec("FM", 200000, 2),
            DemodGroupSpec("BPSK", 20000, 1)]


def _demo_block(rng, block_len, fs):
    """Deterministic multi-station capture; every process generates the
    SAME full block from the shared seed, then keeps only its local span
    (standing in for its local SDR feeding just that span)."""
    t = np.arange(block_len) / fs
    msg = np.sin(2 * np.pi * 1000.0 * t)
    iq = (0.7 * np.exp(1j * (2 * np.pi * 150e3 * t
                             + 2 * np.pi * 75e3 * np.cumsum(msg) / fs))
          + 0.5 * np.exp(2j * np.pi * -300e3 * t)
          + 0.05 * (rng.standard_normal(block_len)
                    + 1j * rng.standard_normal(block_len))
          ).astype(np.complex64)
    return iq


def _check_addressable(arr, ref, **tol):
    """Compare a (possibly cross-process) sharded output against the local
    reference, shard by addressable shard — no cross-host gather needed."""
    for s in arr.addressable_shards:
        np.testing.assert_allclose(np.asarray(s.data), ref[s.index], **tol)


def run_worker(coordinator: str, num_processes: int, process_id: int,
               steps: int = 2, verify: bool = True,
               timed_steps: int = 0) -> dict:
    """One process of the distributed receive job. Initializes
    jax.distributed, builds the global ('time', 'chan'=1) mesh over ALL
    devices, feeds its local IQ span per block via ``shard_iq_local``, and
    (optionally) verifies every output's addressable shards against a
    locally-computed unsharded reference. ``timed_steps`` appends a
    steady-state timing phase (pre-generated local spans, no verify) and
    reports aggregate MS/s + the host-side ingest-scatter share."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    from cubicsdr.ops.planar import PLANAR, from_complex
    from cubicsdr.parallel.mesh import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    from cubicsdr.receiver import ReceiverPipeline

    n_dev = len(jax.devices())
    mesh = make_receiver_mesh(n_time=n_dev, n_chan=1)
    groups = _demo_groups()
    rx = ShardedReceiver(DEMO_FS, num_channels=DEMO_CHANNELS,
                         groups=groups, mesh=mesh)
    controls = rx.control_template()
    controls[0]["frequency"][:] = 150e3
    controls[1]["frequency"][:] = -300e3
    step = rx.make_step()
    state = rx.place_state(rx.init_state())

    ref = None
    if verify:
        pipe = ReceiverPipeline(DEMO_FS, groups, chan_mode="pfbch2",
                                num_channels=DEMO_CHANNELS, dtype=PLANAR,
                                block_len=rx.block_len)
        ref_step = jax.jit(pipe.apply)
        ref_state = pipe.init_state()

    span = rx.block_len // num_processes
    lo, hi = process_id * span, (process_id + 1) * span
    rng = np.random.default_rng(0xD15C0)
    for _ in range(steps):
        iq = _demo_block(rng, rx.block_len, DEMO_FS)
        local = np.stack([iq.real[lo:hi], iq.imag[lo:hi]])
        state, out = step(state, rx.shard_iq_local(local), controls)
        if verify:
            ref_state, ref = ref_step(ref_state, (from_complex(iq),
                                                  controls))
            _check_addressable(out["mix"], np.asarray(ref["mix"]),
                               atol=3e-3, rtol=1e-3)
            _check_addressable(out["groups"][0]["audio"],
                               np.asarray(ref["groups"][0]["audio"]),
                               atol=3e-3, rtol=1e-3)
            _check_addressable(out["groups"][0]["level"],
                               np.asarray(ref["groups"][0]["level"]),
                               atol=0.05, rtol=0)
            syms = out["groups"][1]["symbols"]
            ref_syms = np.asarray(ref["groups"][1]["symbols"])
            for s in syms.addressable_shards:
                agree = np.mean(np.asarray(s.data) == ref_syms[s.index])
                assert agree > 0.999, agree
    jax.block_until_ready(out["mix"])
    rep = {"process_id": process_id,
           "process_count": int(jax.process_count()),
           "local_devices": len(jax.local_devices()),
           "global_devices": n_dev,
           "block_len": rx.block_len, "steps": steps,
           "verified": bool(verify), "ok": True}
    if timed_steps:
        import time
        spans = [np.stack([b.real[lo:hi], b.imag[lo:hi]])
                 for b in (_demo_block(rng, rx.block_len, DEMO_FS)
                           for _ in range(4))]
        # Warm (compiles already done above) + measure the ingest
        # scatter (host->global-array assembly) share separately.
        state, out = step(state, rx.shard_iq_local(spans[0]), controls)
        jax.block_until_ready(out["mix"])
        t0 = time.perf_counter()
        for i in range(timed_steps):
            sh = rx.shard_iq_local(spans[i % 4])
        t_scatter = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(timed_steps):
            state, out = step(state, rx.shard_iq_local(spans[i % 4]),
                              controls)
        jax.block_until_ready(out["mix"])
        dt = time.perf_counter() - t0
        rep["timed"] = {
            "steps": timed_steps,
            "wall_s": round(dt, 4),
            "aggregate_msps": round(
                timed_steps * rx.block_len / dt / 1e6, 2),
            "ingest_scatter_s": round(t_scatter, 4),
            "ingest_scatter_share": round(t_scatter / dt, 4)}
    return rep


def launch_local(num_processes: int = 2, steps: int = 2,
                 devices_per_process: int = 4, port: int = 0,
                 timeout_s: float = 600.0,
                 timed_steps: int = 0) -> list[dict]:
    """Spawn ``num_processes`` CPU worker processes on localhost (the DCN
    demo/test path: gloo over loopback) and collect their JSON reports."""
    import socket
    if not port:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    env = dict(os.environ)
    # A local CPU fleet per process: the workers stay off any accelerator.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_process}")
    procs = []
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cubicsdr", "multihost", "--worker",
             "--coordinator", f"localhost:{port}",
             "--nprocs", str(num_processes), "--process-id", str(pid),
             "--steps", str(steps), "--timed-steps", str(timed_steps)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    reports = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            raise
        if p.returncode != 0:
            raise RuntimeError(
                f"worker rc={p.returncode}\nstdout:{out[-2000:]}\n"
                f"stderr:{err[-2000:]}")
        line = [ln for ln in out.splitlines()
                if ln.startswith('{"process_id"')][-1]
        reports.append(json.loads(line))
    return reports
