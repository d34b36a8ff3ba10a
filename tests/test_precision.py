"""Signal-path precision is pinned: every dot_general and
conv_general_dilated the receiver traces asks for Precision.HIGHEST.

At default precision a GPU may run float32 products in TF32 (~10 mantissa
bits), which costs tens of dB of audio SNR against the chain's 60 dB
filters; CPU runs are exact either way, so only the traced program can
show a site that forgot to ask."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from cubicsdr.modems import make_modem, modem_names
from cubicsdr.ops.planar import PC, PLANAR
from cubicsdr.receiver import DemodGroupSpec, ReceiverPipeline

PRODUCTS = ("dot_general", "conv_general_dilated")


def _products(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in PRODUCTS:
            out.append((eqn.primitive.name, eqn.params.get("precision")))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, ClosedJaxpr):
                    _products(sub.jaxpr, out)
                elif isinstance(sub, Jaxpr):
                    _products(sub, out)
    return out


def _assert_pinned(fn, *args):
    found = _products(jax.make_jaxpr(fn)(*args).jaxpr, [])
    assert found, "no dot/conv traced: the check would be vacuous"
    loose = [(name, prec) for name, prec in found
             if prec is None or any(p != jax.lax.Precision.HIGHEST
                                    for p in prec)]
    assert not loose, loose


def _zeros_iq(rx):
    if rx.dtype == PLANAR:
        return PC(jnp.zeros(rx.block_len), jnp.zeros(rx.block_len))
    return jnp.zeros(rx.block_len, jnp.complex64)


@pytest.mark.parametrize("name", modem_names("analog")
                         + modem_names("digital"))
def test_every_modem_plan_is_pinned(name):
    """One plan per modem: channelizer, route/resample, kit, squelch, mix."""
    bw = int(make_modem(name).default_sample_rate)
    rx = ReceiverPipeline(2_400_000, [DemodGroupSpec(name, bw, 2)],
                          dtype=PLANAR)
    _assert_pinned(rx.apply, rx.init_state(),
                   (_zeros_iq(rx), rx.control_template()))


def test_flagship_farm_is_pinned():
    rx = ReceiverPipeline(8_000_000, [DemodGroupSpec("FM", 200000, 16)],
                          num_channels=16, dtype=PLANAR)
    _assert_pinned(rx.apply, rx.init_state(),
                   (_zeros_iq(rx), rx.control_template()))


def test_mixed_fidelity_plan_is_pinned():
    from cubicsdr.receiver import fidelity
    rx = ReceiverPipeline(fidelity.FS, fidelity.plan_specs(),
                          num_channels=fidelity.NUM_CHANNELS, dtype=PLANAR)
    _assert_pinned(rx.apply, rx.init_state(),
                   (_zeros_iq(rx), rx.control_template()))


@pytest.mark.parametrize("form", ["matmul", "conv"])
def test_route_forms_are_pinned(form, monkeypatch):
    import cubicsdr.receiver.frontend as fr
    monkeypatch.setattr(fr, "XLA_ROUTE_FORM", form)
    rx = ReceiverPipeline(8_000_000, [DemodGroupSpec("FM", 200000, 4)],
                          num_channels=16, dtype=PLANAR)
    _assert_pinned(rx.apply, rx.init_state(),
                   (_zeros_iq(rx), rx.control_template()))


@pytest.mark.parametrize("chan_mode", ["pfbch", "pfbch2", "single"])
def test_complex64_plans_are_pinned(chan_mode):
    rx = ReceiverPipeline(1_000_000, [DemodGroupSpec("FM", 200000, 2),
                                      DemodGroupSpec("AM", 10000, 1)],
                          chan_mode=chan_mode, num_channels=4)
    _assert_pinned(rx.apply, rx.init_state(),
                   (_zeros_iq(rx), rx.control_template()))


@pytest.mark.parametrize("kind", ["sos", "first_order", "dc_blocked"])
def test_iir_scans_are_pinned(kind):
    """The IIR scan matrices sit in a feedback path."""
    from cubicsdr.ops.iir import DCBlocker, FirstOrderIIR, SOSFilter
    x = jnp.zeros((3, 2048), jnp.float32)
    if kind == "sos":
        op = SOSFilter(np.array([[1.0, 0.2, 0.1, 1.0, -0.5, 0.1]]),
                       batch_shape=(3,))
    elif kind == "first_order":
        op = FirstOrderIIR([0.5, 0.5], [1.0, -0.3], batch_shape=(3,))
    else:
        op = DCBlocker(batch_shape=(3,), dtype=jnp.float32)
    _assert_pinned(op.apply, op.init_state(), x)


def test_sharded_step_is_pinned():
    from cubicsdr.parallel import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    mesh = make_receiver_mesh(n_time=2, n_chan=2, devices=jax.devices()[:4])
    rx = ShardedReceiver(1_000_000, num_channels=8, mesh=mesh,
                         groups=[DemodGroupSpec("FM", 200000, 2),
                                 DemodGroupSpec("BPSK", 20000, 2)])
    iq = PC(jnp.zeros(rx.block_len), jnp.zeros(rx.block_len))
    _assert_pinned(rx.make_step(), rx.init_state(), iq,
                   rx.control_template())


def test_spectrum_processor_is_pinned():
    from cubicsdr.visual import PlanarSpectrumProcessor
    sp = PlanarSpectrumProcessor(1024)
    frames = PC(jnp.zeros((2, 2048)), jnp.zeros((2, 2048)))
    _assert_pinned(lambda s, f: sp.apply(s, f), sp.init_state(), frames)
