"""Headless waterfall: rolling line buffer + palette mapping.

The reference uploads palette-indexed rows into a GL texture ring
(ref: src/panel/WaterfallPanel.cpp:110-153, 512 main / 256 demod lines,
CubicSDRDefs.h:50-56). Here the waterfall is a rolling [lines, fft_size]
array of normalized spectrum points plus an RGB render, consumable by any
frontend (PNG writer, notebook, web canvas).
"""

from __future__ import annotations

import numpy as np

from cubicsdr.visual.gradient import THEMES, Gradient

DEFAULT_WATERFALL_LINES = 512      # ref: src/CubicSDRDefs.h:50


class Waterfall:
    def __init__(self, fft_size: int, lines: int = DEFAULT_WATERFALL_LINES,
                 theme: str = "default"):
        self.fft_size = int(fft_size)
        self.lines = int(lines)
        self.buffer = np.zeros((self.lines, self.fft_size), np.float32)
        self._palette = THEMES[theme].generate(256)
        self.theme_name = theme

    def set_theme(self, theme: str):
        self._palette = THEMES[theme].generate(256)
        self.theme_name = theme

    def add_lines(self, points: np.ndarray):
        """points: [n, fft_size] or [fft_size] normalized 0..1 rows
        (newest last). Rolls the buffer like the GL texture ring."""
        points = np.atleast_2d(np.asarray(points, np.float32))
        n = min(len(points), self.lines)
        self.buffer = np.roll(self.buffer, -n, axis=0)
        self.buffer[-n:] = points[-n:]

    def render_rgb(self) -> np.ndarray:
        """[lines, fft_size, 3] float RGB via the palette."""
        idx = np.clip(self.buffer * 255.0, 0, 255).astype(np.int32)
        return self._palette[idx]

    def render_png(self, path: str):
        with open(path, "wb") as f:
            f.write(self.render_png_bytes())

    def render_png_bytes(self) -> bytes:
        img = (self.render_rgb() * 255).astype(np.uint8)
        return png_bytes(img)


def png_bytes(rgb: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder (8-bit RGB)."""
    import struct
    import zlib
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))
