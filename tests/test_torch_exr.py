"""The port's EXR codec against moonshine_tpu's, byte for byte: every
compression (NONE / RLE / ZIPS / ZIP / PIZ) x pixel type (half / float)
x 3 or 4 channels, each way; luminance-only files and bytes input."""

import struct
import zlib

import numpy as np
import pytest

from moonshine_tpu.io import exr as J
from moonshine_tpu_torch.io import exr as P

COMPRESSIONS = {"none": P.NO_COMPRESSION, "rle": P.RLE, "zips": P.ZIPS,
                "zip": P.ZIP, "piz": P.PIZ}
PIXEL_TYPES = {"half": P.PT_HALF, "float": P.PT_FLOAT}


def hdr_image(h=37, w=29, c=3, seed=0):
    """Smooth gradients (which PIZ and ZIP shrink) plus seeded HDR noise and
    a bright patch, so every codec path runs."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, (xx + yy) / (w + h), 0.5 + 0 * xx],
                   -1)[..., :c]
    img = img + rs.exponential(0.3, img.shape).astype(np.float32) * (
        rs.rand(h, w, 1) < 0.3)
    img[3:6, 4:9] = 40.0
    return img.astype(np.float32)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("pixel_type", PIXEL_TYPES)
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_codec_matches_reference(tmp_path, compression, pixel_type,
                                 channels):
    img = hdr_image(c=channels, seed=channels)
    comp, pt = COMPRESSIONS[compression], PIXEL_TYPES[pixel_type]
    ours, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    P.write_exr(ours, img, compression=comp, pixel_type=pt)
    J.write_exr(theirs, img, compression=comp, pixel_type=pt)
    assert ours.read_bytes() == theirs.read_bytes()
    stored = img.astype(np.float16 if pixel_type == "half" else np.float32)
    want = np.ones(img.shape[:2] + (4,), np.float32)
    want[..., :channels] = stored
    for got in (P.read_exr(theirs), J.read_exr(ours), P.read_exr(ours),
                P.read_exr(theirs.read_bytes())):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def luminance_exr(y_plane: np.ndarray, compression: int) -> bytes:
    """A Y-only half EXR (the layout of grey HDR archives), assembled with
    the reference codec's own chunk encoders."""
    h, w = y_plane.shape
    chlist = b"Y\x00" + struct.pack("<i4xii", J.PT_HALF, 1, 1) + b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        J._attr("channels", "chlist", chlist),
        J._attr("compression", "compression", bytes([compression])),
        J._attr("dataWindow", "box2i", box),
        J._attr("displayWindow", "box2i", box),
        J._attr("lineOrder", "lineOrder", b"\x00"), b"\x00"])
    lines = {J.ZIP: 16, J.PIZ: 32}.get(compression, 1)
    chunks = []
    for y0 in range(0, h, lines):
        n = min(lines, h - y0)
        raw = np.ascontiguousarray(y_plane[y0:y0 + n].astype(np.float16)
                                   ).view(np.uint8).reshape(-1)
        if compression in (J.ZIP, J.ZIPS):
            payload = zlib.compress(J._zip_preprocess(raw), 6)
        elif compression == J.PIZ:
            payload = J._piz_compress(raw.tobytes(), [("Y", J.PT_HALF, 1, 1)],
                                      w, n)
        else:
            payload = raw.tobytes()
        if len(payload) >= len(raw):
            payload = raw.tobytes()
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)
    offsets, pos = [], 8 + len(header) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    return (struct.pack("<ii", J.MAGIC, 2) + header
            + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks))


@pytest.mark.parametrize("compression", ["none", "zip", "piz"])
def test_luminance_only_files(compression):
    y = hdr_image(c=1, seed=5)[..., 0]
    data = luminance_exr(y, COMPRESSIONS[compression])
    got = P.read_exr(data)
    np.testing.assert_array_equal(got, J.read_exr(data))
    for c in range(3):
        np.testing.assert_array_equal(got[..., c],
                                      y.astype(np.float16).astype(np.float32))
    assert (got[..., 3] == 1.0).all()


def test_rejects_what_the_reference_rejects(tmp_path):
    with pytest.raises(ValueError, match="not an EXR"):
        P.read_exr(b"\x00" * 64)
    with pytest.raises(ValueError):
        P.write_exr(tmp_path / "x.exr", np.zeros((4, 4, 2), np.float32))
