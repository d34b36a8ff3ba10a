"""Scaling-efficiency harness: samples/s at 1 device -> N devices.

Runs the sharded receiver over growing mesh slices and reports throughput +
efficiency; on the CPU 8-device virtual mesh it validates the machinery
(absolute numbers only mean something on real accelerators, where the halo
permutes ride the device interconnect).
"""

from __future__ import annotations

import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.parallel.mesh import make_receiver_mesh
from cubicsdr.parallel.sharded import ShardedReceiver
from jax.sharding import PartitionSpec as P


def measure_scaling(sample_rate: float = 2_400_000, num_channels: int = 16,
                    demods_per_chip: int = 16,
                    device_counts: list[int] | None = None,
                    per_shard_len: int | None = None,
                    n_iters: int = 10, warmup: int = 2) -> dict:
    """Weak scaling: per-device work constant (demods_per_chip rows, fixed
    per-shard block), devices on the 'time' axis. Returns a report dict."""
    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devs)]
    rows = []
    for n in device_counts:
        mesh = make_receiver_mesh(n_time=n, n_chan=1, devices=devs[:n])
        rx = ShardedReceiver(sample_rate, num_channels,
                             n_demods=demods_per_chip, mesh=mesh,
                             block_len=None)
        if per_shard_len:
            rx = ShardedReceiver(sample_rate, num_channels,
                                 n_demods=demods_per_chip, mesh=mesh,
                                 block_len=per_shard_len * n)
        step = rx.make_step()
        state = rx.place_state(rx.init_state())
        rng = np.random.default_rng(0)
        iq = rx.shard_iq((rng.standard_normal(rx.block_len)
                          + 1j * rng.standard_normal(rx.block_len))
                         .astype(np.complex64))
        controls = rx.control_template()
        controls[0]["frequency"] = np.linspace(
            -sample_rate / 4, sample_rate / 4, rx.n_demods
        ).astype(np.float32)
        for _ in range(warmup):
            state, outs = step(state, iq, controls)
        jax.block_until_ready(outs)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            state, outs = step(state, iq, controls)
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        msps = rx.block_len * n_iters / dt / 1e6
        rows.append({"devices": n, "block_len": rx.block_len,
                     "msps": round(msps, 2)})
    base = rows[0]["msps"]
    for r in rows:
        r["efficiency"] = round(r["msps"] / (base * r["devices"]), 3)
    return {"metric": "sharded_fm_farm_weak_scaling", "rows": rows}


if __name__ == "__main__":
    print(json.dumps(measure_scaling(), indent=2))
