"""Scanline EXR reading, uncompressed or zlib (ZIPS / ZIP) only.

The JAX package's codec (moonshine_tpu/io/exr.py) reads and writes every
common variant; this reader covers what the port's checks read (the
committed golden images) so that the port's run on the card imports
nothing of the JAX package. Other compressions raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
NO_COMPRESSION, ZIPS, ZIP = 0, 2, 3
_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}


def _zip_postprocess(raw: bytes) -> np.ndarray:
    """Undo OpenEXR's ZIP predictor and byte interleave."""
    data = np.frombuffer(raw, np.uint8).astype(np.int32)
    data = np.cumsum(np.concatenate([data[:1], data[1:] - 128]),
                     dtype=np.int64)
    data = (data & 0xFF).astype(np.uint8)
    half = (len(data) + 1) // 2
    out = np.empty(len(data), np.uint8)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _header(buf: bytes):
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC or version & 0x200:
        raise ValueError("not a single-part EXR file")
    off = 8
    attrs = {}
    while buf[off] != 0:
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode()
        end2 = buf.index(b"\x00", end + 1)
        type_ = buf[end + 1:end2]
        (size,) = struct.unpack_from("<i", buf, end2 + 1)
        data = buf[end2 + 5:end2 + 5 + size]
        if type_ == b"chlist":
            chans, p = [], 0
            while data[p] != 0:
                e = data.index(b"\x00", p)
                chans.append((data[p:e].decode("latin-1"),
                              struct.unpack_from("<i", data, e + 1)[0]))
                p = e + 17
            attrs[name] = chans
        elif type_ == b"box2i":
            attrs[name] = struct.unpack("<4i", data)
        elif type_ == b"compression":
            attrs[name] = data[0]
        off = end2 + 5 + size
    return attrs, off + 1


def read_exr(path) -> np.ndarray:
    """Load an EXR as [H, W, 4] float32 RGBA (alpha 1 when absent)."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, off = _header(buf)
    channels = attrs["channels"]
    comp = attrs["compression"]
    if comp not in (NO_COMPRESSION, ZIPS, ZIP):
        raise ValueError(f"EXR compression {comp} not supported here")
    x_min, y_min, x_max, y_max = attrs["dataWindow"]
    width, height = x_max - x_min + 1, y_max - y_min + 1
    lines = 16 if comp == ZIP else 1
    n_chunks = (height + lines - 1) // lines
    off += 8 * n_chunks  # offset table; chunks follow in order
    row_bytes = sum(np.dtype(_DTYPES[t]).itemsize * width for _, t in channels)
    planes = {c: np.zeros((height, width), np.float32) for c, _ in channels}
    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, off)
        payload = buf[off + 8:off + 8 + size]
        off += 8 + size
        n_lines = min(lines, y_max - y + 1)
        raw = payload
        if comp != NO_COMPRESSION and size != row_bytes * n_lines:
            raw = _zip_postprocess(zlib.decompress(payload)).tobytes()
        pos = 0
        for line in range(n_lines):
            for name, ptype in channels:
                dt = np.dtype(_DTYPES[ptype])
                planes[name][y - y_min + line] = np.frombuffer(
                    raw, dt, width, pos).astype(np.float32)
                pos += dt.itemsize * width
    out = np.ones((height, width, 4), np.float32)
    for i, ch in enumerate("RGBA"):
        if ch in planes:
            out[..., i] = planes[ch]
    return out
