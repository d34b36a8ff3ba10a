"""Native ingest runtime: builds/loads the C++ shared library, with a pure
numpy fallback when no compiler is available.

API:
  deinterleave(raw_bytes_or_array, fmt) -> (re, im) float32 numpy planes
  float_to_pcm16(audio) -> int16 numpy
  SampleRing(capacity) -> bounded planar ring with try-push shedding
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")
# Built at first use, never committed: the library's name carries a hash
# of the source and the compile command, so an edit (or a checkout copied
# from another machine) rebuilds instead of loading a stale binary.
_BUILD_DIR = os.path.join(_HERE, "_build")
_CXX = ["g++", "-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_CXX).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"_ingest-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run([*_CXX, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)        # atomic: concurrent builders never tear
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        so = _lib_path()
        if not os.path.exists(so) and not _build(so):
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _lib = False
            return None
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        lib.cs_deinterleave_cf32.argtypes = [c_f32p, ctypes.c_int64,
                                             c_f32p, c_f32p]
        lib.cs_convert_cs16.argtypes = [c_i16p, ctypes.c_int64,
                                        c_f32p, c_f32p]
        lib.cs_convert_cs8.argtypes = [ctypes.POINTER(ctypes.c_int8),
                                       ctypes.c_int64, c_f32p, c_f32p]
        lib.cs_convert_cu8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int64, c_f32p, c_f32p]
        lib.cs_float_to_pcm16.argtypes = [c_f32p, ctypes.c_int64, c_i16p]
        lib.cs_ring_create.restype = ctypes.c_void_p
        lib.cs_ring_create.argtypes = [ctypes.c_int64]
        lib.cs_ring_create2.restype = ctypes.c_void_p
        lib.cs_ring_create2.argtypes = [ctypes.c_int64, ctypes.c_int32]
        lib.cs_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.cs_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64]
        lib.cs_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64]
        lib.cs_ring_fill.argtypes = [ctypes.c_void_p]
        lib.cs_ring_fill.restype = ctypes.c_int64
        lib.cs_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.cs_ring_dropped.restype = ctypes.c_int64
        _lib = lib
        return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def deinterleave(raw: np.ndarray, fmt: str = "cf32"):
    """Interleaved wire samples -> planar (re, im) float32.

    fmt: cf32 | cs16 | cs8 | cu8. Uses the native loops when available.
    """
    lib = get_lib()
    dt = {"cf32": np.float32, "cs16": np.int16,
          "cs8": np.int8, "cu8": np.uint8}[fmt]
    raw = np.ascontiguousarray(np.asarray(raw).view(dt).ravel())
    n = raw.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if lib is not None:
        fn = {"cf32": lib.cs_deinterleave_cf32,
              "cs16": lib.cs_convert_cs16,
              "cs8": lib.cs_convert_cs8,
              "cu8": lib.cs_convert_cu8}[fmt]
        ct = {"cf32": ctypes.c_float, "cs16": ctypes.c_int16,
              "cs8": ctypes.c_int8, "cu8": ctypes.c_uint8}[fmt]
        fn(_ptr(raw, ct), n, _ptr(re, ctypes.c_float),
           _ptr(im, ctypes.c_float))
        return re, im
    # numpy fallback
    f = raw.astype(np.float32)
    if fmt == "cs16":
        f /= 32768.0
    elif fmt == "cs8":
        f /= 128.0
    elif fmt == "cu8":
        f = (f - 127.5) / 127.5
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


def float_to_pcm16(audio: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(np.asarray(audio, np.float32).ravel())
    if lib is not None:
        out = np.empty(a.size, np.int16)
        lib.cs_float_to_pcm16(_ptr(a, ctypes.c_float), a.size,
                              _ptr(out, ctypes.c_int16))
        return out
    return (np.clip(a, -1, 1) * 32767.0).astype(np.int16)


class SampleRing:
    """Bounded planar ring with try-push shedding (native when available).

    ``dtype`` sets the stored sample format: float32 (default) or a wire
    format (int16/int8) for native-format ingest — fewer bytes through
    host memory and over the host->device link, converted on-device."""

    def __init__(self, capacity: int, dtype=np.float32):
        self.capacity = int(capacity)
        self.dtype = np.dtype(dtype)
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.cs_ring_create2(self.capacity,
                                                self.dtype.itemsize)
        else:
            self._re = np.zeros(capacity, self.dtype)
            self._im = np.zeros(capacity, self.dtype)
            self._head = 0
            self._size = 0
            self.dropped = 0
            self._mu = threading.Lock()

    def _vp(self, a: np.ndarray):
        # The caller must keep ``a`` alive and contiguous for the C call:
        # a silent ascontiguousarray copy here would be a temporary whose
        # pointer can dangle before the callee consumes it.
        assert a.flags.c_contiguous, "pass a C-contiguous array to _vp"
        return ctypes.c_void_p(a.ctypes.data)

    def write(self, re: np.ndarray, im: np.ndarray) -> bool:
        n = len(re)
        if self._lib is not None:
            re = np.ascontiguousarray(re, self.dtype)
            im = np.ascontiguousarray(im, self.dtype)
            return bool(self._lib.cs_ring_write(
                self._h, self._vp(re), self._vp(im), n))
        with self._mu:
            if self._size + n > self.capacity:
                self.dropped += n
                return False
            w = (self._head + self._size) % self.capacity
            first = min(n, self.capacity - w)
            self._re[w:w + first] = re[:first]
            self._im[w:w + first] = im[:first]
            if n > first:
                self._re[: n - first] = re[first:]
                self._im[: n - first] = im[first:]
            self._size += n
            return True

    def read(self, n: int):
        if self._lib is not None:
            re = np.empty(n, self.dtype)
            im = np.empty(n, self.dtype)
            ok = self._lib.cs_ring_read(self._h, self._vp(re),
                                        self._vp(im), n)
            return (re, im) if ok else None
        with self._mu:
            if self._size < n:
                return None
            idx = (self._head + np.arange(n)) % self.capacity
            re, im = self._re[idx].copy(), self._im[idx].copy()
            self._head = (self._head + n) % self.capacity
            self._size -= n
            return re, im

    @property
    def fill(self) -> int:
        if self._lib is not None:
            return int(self._lib.cs_ring_fill(self._h))
        with self._mu:
            return self._size

    @property
    def dropped_samples(self) -> int:
        if self._lib is not None:
            return int(self._lib.cs_ring_dropped(self._h))
        return self.dropped

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            try:
                self._lib.cs_ring_destroy(self._h)
            except Exception:
                pass
