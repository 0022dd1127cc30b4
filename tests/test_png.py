"""The numpy PNG reader against Pillow: synthetic images of every supported
colour type, bit depth and scanline filter, and every fixture frame."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from align3d_tpu import config
from align3d_tpu.io.png import PngError, decode_png, read_png

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(cur, prev, bpp, kind):
    """PNG scanline filter ``kind`` (0-4) of one row of bytes."""
    cur = cur.astype(np.int32)
    prev = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    pred = {
        0: np.zeros_like(cur),
        1: left,
        2: prev,
        3: (left + prev) // 2,
        4: _paeth(left, prev, upleft),
    }[kind]
    return ((cur - pred) & 0xFF).astype(np.uint8)


def _chunk(ctype, body):
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def encode_png(img, color, depth, filters):
    """A PNG of ``img`` whose row r uses scanline filter ``filters[r % len]``."""
    h, w = img.shape[:2]
    channels = _CHANNELS[color]
    dtype = ">u2" if depth == 16 else np.uint8
    rows = np.ascontiguousarray(img.reshape(h, w * channels).astype(dtype))
    rows = rows.view(np.uint8).reshape(h, -1)
    bpp = channels * depth // 8
    prev = np.zeros(rows.shape[1], np.uint8)
    raw = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        raw.append(kind)
        raw += _filter_row(rows[r], prev, bpp, kind).tobytes()
        prev = rows[r]
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(bytes(raw)))
        + _chunk(b"IEND", b"")
    )


def _pillow(data, tmp_path):
    from PIL import Image

    path = tmp_path / "img.png"
    path.write_bytes(data)
    arr = np.asarray(Image.open(path))
    return arr.astype(np.uint16) if arr.dtype == np.int32 else arr


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize(
    "color,depth",
    [(0, 8), (0, 16), (2, 8), (4, 8), (6, 8)],
    ids=["gray8", "gray16", "rgb8", "gray_alpha8", "rgba8"],
)
def test_decode_matches_pillow(color, depth, kind, tmp_path):
    """Every supported colour type and bit depth under each scanline filter
    (``None``: all five filters, rotating by row) decodes bit-identically to
    Pillow."""
    rng = np.random.default_rng(color * 100 + depth + (kind or 7))
    h, w = 13, 17
    shape = (h, w) if _CHANNELS[color] == 1 else (h, w, _CHANNELS[color])
    img = rng.integers(0, 2**depth, size=shape).astype(
        np.uint16 if depth == 16 else np.uint8
    )
    filters = [0, 1, 2, 3, 4] if kind is None else [kind]
    data = encode_png(img, color, depth, filters)
    got = decode_png(data)
    np.testing.assert_array_equal(got, img)
    ref = _pillow(data, tmp_path)
    if color in (0, 4, 6) or depth == 8:  # Pillow's own modes for these
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _fixture_frames():
    return sorted(glob.glob(os.path.join(config.ref_data_path("rgbd"), "*", "*.png")))


@pytest.mark.parametrize("sample", ["sample1", "sample2"])
@pytest.mark.parametrize("kind", ["rgb", "depth"])
def test_fixture_frames_match_pillow(sample, kind):
    """Every SlamTb fixture frame (8-bit RGB colour, 16-bit gray depth)
    decodes bit-identically to Pillow."""
    from PIL import Image

    frames = [
        p for p in _fixture_frames()
        if os.sep + sample + os.sep in p and p.endswith(f"_{kind}.png")
    ]
    if not frames:
        pytest.skip("fixture frames not available")
    for path in frames:
        ref = np.asarray(Image.open(path))
        if ref.dtype == np.int32:
            ref = ref.astype(np.uint16)
        got = read_png(path)
        assert got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda d: b"GIF89a" + d[6:], "not a PNG"),
        (lambda d: d[:40], "truncated|IEND"),
        (lambda d: d.replace(struct.pack(">BB", 8, 0), struct.pack(">BB", 8, 3), 1), "colour type 3"),
    ],
    ids=["signature", "truncated", "palette"],
)
def test_rejects_bad_or_unsupported(mutate, match):
    data = encode_png(np.zeros((4, 4), np.uint8), 0, 8, [0])
    with pytest.raises(PngError, match=match):
        decode_png(mutate(data))


def test_png_path_does_not_import_pillow():
    """Loading a fixture frame never imports Pillow."""
    import subprocess
    import sys

    frames = _fixture_frames()
    if not frames:
        pytest.skip("fixture frames not available")
    code = (
        "import sys\n"
        "from align3d_tpu.io.datasets.core import load_rgb, load_depth_u16\n"
        f"load_rgb({frames[1]!r}); load_depth_u16({frames[0]!r})\n"
        "assert 'PIL' not in sys.modules, 'Pillow was imported'\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
