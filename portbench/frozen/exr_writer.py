"""Frozen copy of the ZIP writer of moonshine_tpu_torch/io/exr.py at
commit 747dbd6 (`write_exr` with ZIP compression and float pixels, and
the `_zip_preprocess` and `_attr` it uses): the benchmark writes its sky
with it, and the program reads the file back with its own reader."""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_FLOAT = 2
ZIP = 3


def _zip_preprocess(data: np.ndarray) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    t = tmp.astype(np.int32)
    d = np.empty(n, np.int32)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def write_exr(path, image: np.ndarray) -> None:
    """Write [H, W, 3] float32 data as a ZIP scanline EXR of float
    channels (lossless: the reader gets the same float32 values)."""
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("image must be [H, W, 3]")
    H, W, _ = image.shape
    names = sorted(["B", "G", "R"])
    src = {"R": 0, "G": 1, "B": 2}

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<i4xii", PT_FLOAT, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            _attr("channels", "chlist", chlist),
            _attr("compression", "compression", bytes([ZIP])),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", b"\x00"),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    lines_per_chunk = 16
    n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk
    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lines_per_chunk
        n_lines = min(lines_per_chunk, H - y0)
        rows = []
        for line in range(n_lines):
            for n in names:
                rows.append(np.ascontiguousarray(
                    image[y0 + line, :, src[n]]).view(np.uint8))
        raw = np.concatenate(rows)
        payload = zlib.compress(_zip_preprocess(raw), 6)
        if len(payload) >= len(raw):
            payload = raw.tobytes()  # stored raw, flagged by its size
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)

    base = 8 + len(header) + 8 * n_chunks
    offsets = []
    pos = base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for c in chunks:
            f.write(c)
