"""PNG decoding on the standard library's zlib and numpy, for glTF textures
(the JAX package decodes them with PIL, which the port's GPU host lacks),
and `encode_png`, the viewer's frame encoder (8-bit RGB/RGBA, filter 0).

`decode_png(data) -> uint8 [H, W, 4]` returns what PIL's
`Image.open(...).convert("RGBA")` returns for the same file, and
`png_rgba` that divided by 255 as float32, the texture format of
scene/gltf.py. The port follows PIL's conversions, not the PNG spec's
suggestions, because the JAX package's textures are PIL's: a texture must
decode to the same texels in both packages. Where they part:

  * 16-bit grey (colour type 0): PIL opens it as "I;16" and converts by
    clamping, min(v, 255), not by taking the high byte; so does the port.
    16-bit RGB, RGBA and grey-alpha take the high byte of each sample.
  * 1/2/4-bit grey is scaled to 0..255 (v * 255 / (2^d - 1)); palette
    indices of 1/2/4 bits index the palette; an index past the palette's
    end reads (0, 0, 0), opaque.
  * tRNS: palette alphas per index (opaque past the chunk's end). A grey
    or RGB colour key is compared, as PIL does, with the 8-bit value it
    converted to, not with the sample: the raw key against the clamped
    16-bit grey, against the high bytes of 16-bit RGB, and against the
    scaled 2/4-bit grey; a 1-bit key of 1 (or more) means white.

Chunks are walked with their CRCs checked, IDAT chunks concatenated and
inflated, and the five scanline filters undone over anti-diagonals of
whole pixels (each reconstructed pixel depends on its left, upper and
upper-left neighbours, so one diagonal at a time is one numpy step). An
interlaced (Adam7) file holds seven reduced images one after another,
each filtered on its own; each is unfiltered and unpacked alone and
scattered into the pixels it covers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type: (channels, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# the reduced images of each interlace method: (x0, y0, dx, dy) each
_PASSES = {0: ((0, 0, 1, 1),),
           1: ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    while off + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + length
    raise ValueError("PNG ends without IEND")


def _unfilter(raw: np.ndarray, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: raw is [height * (1 + row_bytes)]
    bytes, each row led by its filter type; returns [height, row_bytes]."""
    rows = raw.reshape(height, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} unknown")
    wp = row_bytes // bpp  # whole pixels (bytes when bpp == 1)
    filt = rows[:, 1:].reshape(height, wp, bpp).astype(np.int32)
    # recon, padded with a zero row above and a zero pixel to the left
    rec = np.zeros((height + 1, wp + 1, bpp), np.int32)
    for diag in range(height + wp - 1):
        y = np.arange(max(0, diag - wp + 1), min(height, diag + 1))
        x = diag - y
        a = rec[y + 1, x]  # left
        b = rec[y, x + 1]  # up
        c = rec[y, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        zero = np.zeros_like(a)
        pred = np.choose(ftype[y][:, None], [zero, a, b, (a + b) >> 1, paeth])
        rec[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return rec[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def _samples(rec: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """[H, W, channels] integer samples from unfiltered rows."""
    h = rec.shape[0]
    if depth == 16:
        flat = rec.view(">u2").astype(np.int64)
    elif depth == 8:
        flat = rec.astype(np.int64)
    else:
        per = 8 // depth
        shifts = (np.arange(per - 1, -1, -1) * depth).astype(np.uint8)
        flat = ((rec[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1).astype(np.int64)
    return flat[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes, name: str = "PNG image") -> np.ndarray:
    """uint8 [H, W, 4]: what PIL's convert("RGBA") gives (module
    docstring). `name` labels errors."""
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"{name}: PNG colour type {ctype} at bit depth "
                         f"{depth} is invalid")
    if interlace not in _PASSES:
        raise ValueError(f"{name}: PNG interlace method {interlace} unknown")
    channels = _COLOR_TYPES[ctype][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    bpp = max(1, channels * depth // 8)
    passes = []  # (x0, y0, dx, dy, pass width, pass height, row bytes)
    for x0, y0, dx, dy in _PASSES[interlace]:
        pw, ph = -(-max(width - x0, 0) // dx), -(-max(height - y0, 0) // dy)
        if pw and ph:  # an empty reduced image has no scanlines at all
            passes.append((x0, y0, dx, dy, pw, ph,
                           (pw * channels * depth + 7) // 8))
    expected = sum(ph * (rb + 1) for *_, ph, rb in passes)
    if raw.size != expected:
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, "
                         f"expected {expected}")
    s = np.zeros((height, width, channels), np.int64)
    off = 0
    for x0, y0, dx, dy, pw, ph, rb in passes:
        n = ph * (rb + 1)
        s[y0::dy, x0::dx] = _samples(_unfilter(raw[off:off + n], ph, rb, bpp),
                                     pw, channels, depth)
        off += n

    out = np.full((height, width, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = s[..., 0]
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[idx]
    if depth == 16:  # PIL: grey clamps, every other type keeps the high byte
        s8 = np.minimum(s, 255) if ctype == 0 else s >> 8
    elif depth < 8:  # grey only
        s8 = s * 255 // ((1 << depth) - 1)
    else:
        s8 = s
    color = s8[..., :3] if ctype in (2, 6) else np.repeat(s8[..., :1], 3, -1)
    out[..., :3] = color
    if ctype in (4, 6):
        out[..., 3] = s8[..., -1]
    elif trns is not None:
        key = np.asarray(struct.unpack(f">{len(trns) // 2}H", trns),
                         np.int64)
        if ctype == 0 and depth == 1:
            key = np.where(key > 0, 255, 0)
        match = (color[..., :len(key)] == key).all(-1)
        out[..., 3] = np.where(match, 0, 255)
    return out


def png_rgba(data: bytes, name: str = "PNG image") -> np.ndarray:
    """float32 [H, W, 4] in [0, 1]: decode_png / 255."""
    return decode_png(data, name).astype(np.float32) / 255.0


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes: 8-bit,
    non-interlaced, every scanline with filter 0, one zlib stream."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    if px.ndim != 3 or px.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {px.shape}")
    h, w, c = px.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)  # leading 0: filter None
    raw[:, 1:] = px.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
