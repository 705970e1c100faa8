"""Minimal dependency-free PNG writer and reader (stdlib zlib), a copy of
``blub_tpu/render/png.py``. The encoder is pure Python (the JAX package may
use its native C++ one; the port has none): the reference encodes PNGs on
worker threads (screenshot_capture.rs), and here encoding is off the
simulation's critical path too."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """rgb: uint8[H, W, 3] -> PNG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3, rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def decode_png(data: bytes):
    """Minimal PNG decoder (stdlib zlib): -> uint8[H, W, 3|4] or None.

    The reference loads real PNG/JPG diffuse
    textures via the image crate (src/scene/models.rs:252-385, sampled in
    shader/mesh.frag); core/models._load_texture feeds decoded PNGs into the
    same sampling path the PPM/checker textures use. Supports the formats
    real-world diffuse maps use: 8-bit RGB / RGBA / grayscale(+alpha) /
    palette, filters 0-4, non-interlaced. Returns None for anything else
    (caller falls back to the procedural checker). Deviation: no JPEG — the
    repo's decoder set is PNG+PPM; JPEG assets fall back to the checker."""
    if len(data) < 8 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos = 8
    w = h = bitdepth = color = interlace = None
    idat = []
    palette = None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitdepth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if w is None or bitdepth != 8 or interlace != 0 or not idat:
        return None
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if nch is None or (color == 3 and palette is None):
        return None
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    stride = w * nch
    if len(raw) < h * (stride + 1):
        return None
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(nch, stride):
                cur[i] = (cur[i] + cur[i - nch]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            return None
        out[y] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, nch)
    if color == 3:
        img = palette[img[..., 0]]
    elif color == 0:
        img = np.repeat(img, 3, axis=2)
    elif color == 4:
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=2), img[..., 1:]], axis=2)
    return img


def read_png(path):
    """Decode a PNG file -> uint8[H, W, 3|4] or None."""
    try:
        with open(path, "rb") as f:
            return decode_png(f.read())
    except OSError:
        return None
