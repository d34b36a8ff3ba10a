"""Native C++ ingest runtime: conversions + ring semantics (built on the
fly with g++; also exercises the numpy fallback paths)."""

import os

import numpy as np
import pytest

from cubicsdr import native


def test_native_lib_builds():
    assert native.get_lib() is not None, "g++ build of _ingest.so failed"


@pytest.mark.parametrize("fmt,dtype,scale", [
    ("cf32", np.float32, 1.0), ("cs16", np.int16, 32768.0),
    ("cs8", np.int8, 128.0),
])
def test_deinterleave_formats(fmt, dtype, scale, rng):
    n = 1000
    vals = (rng.uniform(-1, 1, 2 * n) * (scale - 1)).astype(dtype) \
        if fmt != "cf32" else rng.uniform(-1, 1, 2 * n).astype(np.float32)
    re, im = native.deinterleave(vals, fmt)
    expect_re = vals[0::2].astype(np.float32) / (scale if fmt != "cf32" else 1)
    np.testing.assert_allclose(re, expect_re, atol=1e-6)
    assert re.dtype == np.float32 and len(im) == n


def test_cu8_offset():
    raw = np.asarray([127, 128, 0, 255], np.uint8)
    re, im = native.deinterleave(raw, "cu8")
    np.testing.assert_allclose(re, [-0.5 / 127.5, -1.0], atol=1e-6)
    np.testing.assert_allclose(im, [0.5 / 127.5, 1.0], atol=1e-6)


def test_float_to_pcm16():
    a = np.asarray([0.0, 0.5, 1.0, -1.0, 2.0, -2.0], np.float32)
    out = native.float_to_pcm16(a)
    np.testing.assert_array_equal(
        out, [0, 16383, 32767, -32767, 32767, -32767])


def test_ring_write_read_wraparound(rng):
    ring = native.SampleRing(1000)
    re = np.arange(600, dtype=np.float32)
    im = -re
    assert ring.write(re, im)
    assert ring.fill == 600
    out = ring.read(500)
    assert out is not None
    np.testing.assert_array_equal(out[0], re[:500])
    # wraparound write
    assert ring.write(re, im)
    assert ring.fill == 700
    out2 = ring.read(700)
    np.testing.assert_array_equal(out2[0], np.r_[re[500:], re])


def test_ring_try_push_shedding():
    ring = native.SampleRing(100)
    a = np.ones(80, np.float32)
    assert ring.write(a, a)
    assert not ring.write(a, a)       # would overflow -> batch dropped
    assert ring.dropped_samples == 80
    assert ring.fill == 80
    assert ring.read(90) is None      # not enough data -> no partial read


def test_library_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """The built library's name follows the source: an edit (or a copy of
    the checkout from another machine) builds afresh instead of loading a
    stale binary, and the build lands in the git-ignored build dir."""
    src = tmp_path / "ingest.cpp"
    src.write_bytes(open(native._SRC, "rb").read())
    monkeypatch.setattr(native, "_SRC", str(src))
    a = native._lib_path()
    assert a == native._lib_path()
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    b = native._lib_path()
    assert a != b
    assert os.path.dirname(a) == native._BUILD_DIR


def test_build_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(native._BUILD_DIR, repo)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert rel + "/" in f.read().split()
