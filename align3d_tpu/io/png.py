"""PNG decoding with numpy and the standard library's ``zlib``.

Reads non-interlaced PNGs of colour types gray (0), RGB (2), gray + alpha
(4) and RGBA (6) at 8 or 16 bits per sample — the formats of the SlamTb and
TUM RGB-D captures (8-bit RGB colour, 16-bit gray depth). Palette images,
other bit depths and interlaced files raise :class:`PngError`.

Scanline filters None, Sub and Up are undone with whole-row numpy
operations; Average and Paeth depend on the reconstructed byte to their
left and run a per-byte loop, which is slower but exact.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PngError(ValueError):
    pass


def _paeth_or_average_row(f: np.ndarray, prev: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Undo filter 3 (Average) or 4 (Paeth) on one scanline."""
    fl = f.tolist()
    up = prev.tolist()
    cur = [0] * len(fl)
    for i, x in enumerate(fl):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise PngError("truncated PNG chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PngError("PNG has no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16."""
    if data[: len(SIGNATURE)] != SIGNATURE:
        raise PngError("not a PNG file")
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("PNG has no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    channels = _CHANNELS.get(color)
    if channels is None or depth not in (8, 16):
        raise PngError(f"unsupported PNG colour type {color} at bit depth {depth}")
    if compression or filter_method or interlace:
        raise PngError("interlaced or non-standard PNGs are not supported")

    bpp = channels * depth // 8  # bytes per pixel: the filters' left offset
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise PngError("PNG image data has the wrong size")
    rows = raw.reshape(height, stride + 1)

    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind = int(rows[r, 0])
        f = rows[r, 1:]
        if kind == 0:
            cur = f
        elif kind == 1:  # Sub: a running sum mod 256 per byte lane
            cur = np.cumsum(f.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = f + prev
        elif kind in (3, 4):
            cur = _paeth_or_average_row(f, prev, bpp, kind)
        else:
            raise PngError(f"unknown PNG filter type {kind}")
        out[r] = cur
        prev = out[r]

    if depth == 16:
        pixels = out.view(">u2").astype(np.uint16)
    else:
        pixels = out
    pixels = pixels.reshape(height, width, channels)
    return pixels[..., 0] if channels == 1 else pixels


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
