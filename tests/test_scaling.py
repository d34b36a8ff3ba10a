"""Scaling harness on the virtual CPU mesh: the machinery and its
collectives, on 8 virtual devices that share one CPU (efficiency numbers
only mean something on real accelerators)."""

from cubicsdr.parallel.scaling import measure_scaling


def test_scaling_harness_to_8_devices():
    # Wall-clock canary: retry once before failing — a co-tenant process
    # on this host can skew one measurement pass.
    for attempt in (0, 1):
        rep = measure_scaling(sample_rate=2_000_000, num_channels=8,
                              demods_per_chip=8, device_counts=[1, 2, 4, 8],
                              per_shard_len=None, n_iters=4, warmup=2)
        rows = rep["rows"]
        assert [r["devices"] for r in rows] == [1, 2, 4, 8]
        assert all(r["msps"] > 0 for r in rows)
        assert rows[0]["efficiency"] == 1.0
        # All 8 virtual devices share ONE physical CPU, so weak-scaling
        # "efficiency" is 1/n by construction (aggregate throughput is
        # pinned at the machine's capacity); an efficiency bound is only
        # meaningful on real accelerators. What IS assertable here:
        # the halo/psum collectives must not collapse aggregate throughput
        # as shards grow.
        if rows[-1]["msps"] >= 0.6 * rows[0]["msps"]:
            return
    assert rows[-1]["msps"] >= 0.6 * rows[0]["msps"], rows
