"""The port's JPEG decoder (io/jpeg.py) against PIL's
`Image.open(...).convert("RGBA")`, which is what the JAX package's glTF
loader calls (PIL here is built on libjpeg-turbo), bit for bit: JPEGs
that PIL writes inside the test (baseline 4:4:4 / 4:2:2 / 4:2:0,
grayscale, progressive, optimised Huffman tables, restart markers, odd
sizes down to 1x1) and JPEGs a hand encoder below writes where PIL
cannot (4:4:0 and 4:1:1 sampling, RGB component ids, restart intervals
across interleaved MCUs, coefficients large enough to hit the IDCT's
range-limit wrap); the committed fixtures of tests/torch_fixtures/ (the
ones the card's smoke run decodes) against their PIL goldens; a glb
with a JPEG texture through both packages' loaders and CLIs; the kinds
the port does not read raise; and the DDS header parser against the
reference's (mirroring tests/test_frontends.py:223-245)."""

import io
import pathlib
import struct

import numpy as np
import pytest
from PIL import Image

from moonshine_tpu.io import dds as JD
from moonshine_tpu.scene import gltf as JG
from moonshine_tpu_torch.io import dds as PD
from moonshine_tpu_torch.io import jpeg as PJ
from moonshine_tpu_torch.scene import gltf as PG
from moonshine_tpu_torch.scripts.time_jpeg import hand_jpeg

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_fixtures"


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _image(w, h, seed, mode="RGB"):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                  128 + 100 * np.sin(xx / 3.0 + yy / 5.0)], -1)
    a = np.clip(a + rs.randint(-60, 60, a.shape), 0, 255).astype(np.uint8)
    img = Image.fromarray(a)
    return img.convert("L") if mode == "L" else img


def pil_jpeg(w, h, seed=0, mode="RGB", **save) -> bytes:
    buf = io.BytesIO()
    _image(w, h, seed, mode).save(buf, "JPEG", **save)
    return buf.getvalue()


SIZES = [(17, 13), (64, 48), (33, 31), (4, 3), (2, 2), (1, 1)]
PIL_CASES = {}
for _w, _h in SIZES:
    for _ss in ("4:4:4", "4:2:2", "4:2:0"):
        for _prog in (False, True):
            PIL_CASES[f"{_ss}_{'prog' if _prog else 'base'}_{_w}x{_h}"] = (
                _w, _h, dict(subsampling=_ss, progressive=_prog, quality=85))
    PIL_CASES[f"grey_base_{_w}x{_h}"] = (_w, _h, dict(quality=80), "L")
    PIL_CASES[f"grey_prog_{_w}x{_h}"] = (_w, _h, dict(quality=80,
                                                      progressive=True), "L")
PIL_CASES.update({
    "optimize_420": (40, 24, dict(subsampling="4:2:0", optimize=True)),
    "optimize_prog_444": (23, 19, dict(subsampling="4:4:4", optimize=True,
                                       progressive=True)),
    "restart_blocks_420": (48, 40, dict(subsampling="4:2:0",
                                        restart_marker_blocks=3)),
    "restart_rows_prog_422": (50, 34, dict(subsampling="4:2:2",
                                           progressive=True,
                                           restart_marker_rows=1)),
    "restart_grey": (29, 21, dict(restart_marker_blocks=2), "L"),
    "q100_444": (24, 16, dict(subsampling="4:4:4", quality=100)),
    "q5_420": (24, 16, dict(subsampling="4:2:0", quality=5)),
})


@pytest.mark.parametrize("name", sorted(PIL_CASES))
def test_decoder_matches_pil(name):
    w, h, save, *mode = PIL_CASES[name]
    data = pil_jpeg(w, h, seed=len(name), mode=mode[0] if mode else "RGB",
                    **save)
    if "restart" in name:
        assert b"\xff\xdd" in data  # a DRI segment
    got = PJ.decode_jpeg(data)
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_rgba(data))
    np.testing.assert_array_equal(PJ.jpeg_rgba(data),
                                  pil_rgba(data).astype(np.float32) / 255.0)


# --- files PIL does not write: scripts/time_jpeg.py's baseline encoder of
# seeded coefficients ---

HAND_CASES = {
    "440_17x13": dict(w=17, h=13, sampling=[(1, 2), (1, 1), (1, 1)]),
    "440_restart_40x37": dict(w=40, h=37, sampling=[(1, 2), (1, 1), (1, 1)],
                              restart=3),
    "411_45x20": dict(w=45, h=20, sampling=[(4, 1), (1, 1), (1, 1)]),
    "420_restart_wrap_33x35": dict(w=33, h=35,
                                   sampling=[(2, 2), (1, 1), (1, 1)],
                                   restart=2, big=True),
    "rgb_ids_444_19x9": dict(w=19, h=9, sampling=[(1, 1)] * 3,
                             ids=(82, 71, 66)),
    "422_v2_chroma_24x24": dict(w=24, h=24,
                                sampling=[(2, 2), (1, 2), (1, 2)]),
}


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_decoder_matches_pil_hand_encoded(name):
    data = hand_jpeg(seed=len(name), **HAND_CASES[name])
    np.testing.assert_array_equal(PJ.decode_jpeg(data), pil_rgba(data))


@pytest.mark.parametrize("name", ["baseline_420", "progressive_422",
                                  "grey_restart"])
def test_committed_fixtures(name):
    """The fixtures the card's smoke run decodes: PIL's RGBA of each is
    its committed golden, and the port decodes to it."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    gold = np.load(FIXTURES / f"{name}.npy")
    np.testing.assert_array_equal(pil_rgba(data), gold)
    np.testing.assert_array_equal(PJ.decode_jpeg(data), gold)


def _jpeg_of(mode, **save) -> bytes:
    buf = io.BytesIO()
    Image.new(mode, (8, 8)).save(buf, "JPEG", **save)
    return buf.getvalue()


def _sof_patched(marker: int, precision: int = 8) -> bytes:
    """A PIL baseline file with its SOF0 marker (and precision) changed."""
    data = bytearray(pil_jpeg(8, 8))
    i = data.index(b"\xff\xc0")
    data[i + 1] = marker
    data[i + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("kind,data,reason", [
    ("cmyk", lambda: _jpeg_of("CMYK"), "CMYK"),
    ("arithmetic", lambda: _sof_patched(0xC9), "arithmetic"),
    ("lossless", lambda: _sof_patched(0xC3), "lossless"),
    ("12-bit", lambda: _sof_patched(0xC1, 12), "12-bit"),
    ("unrefined", lambda: pil_jpeg(16, 16, progressive=True)[:-400]
     + b"\xff\xd9", "block smoothing"),
])
def test_unsupported_kinds_raise(kind, data, reason):
    with pytest.raises(NotImplementedError, match=reason):
        PJ.decode_jpeg(data(), kind)


def test_malformed_raises():
    with pytest.raises(ValueError, match="not a JPEG"):
        PJ.decode_jpeg(b"\x89PNG....")


def test_glb_jpeg_texture_loads_like_reference():
    """The Cornell glb with a JPEG base-colour texture (the smoke run's
    scene): both loaders give the same texels, and the port's material
    atlas equals the JAX World's."""
    from chip_smoke import cornell_jpeg_glb
    from test_torch_scene import jax_scene_arrays

    jpeg = (FIXTURES / "baseline_420.jpg").read_bytes()
    glb = cornell_jpeg_glb(jpeg)
    want = JG.Glb.parse(glb).image_rgba(0)
    got = PG.Glb.parse(glb).image_rgba(0)
    np.testing.assert_array_equal(got, want)
    jw, pw = JG.world_from_glb(glb), PG.world_from_glb(glb)
    want_a, _ = jax_scene_arrays(jw.build())
    got_a, _ = pw.build_arrays()
    import torch

    plane = torch.from_numpy(got_a["mat_atlas.bsdf.data"]).to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(plane, want_a["mat_atlas.bsdf.data"])
    assert not np.all(plane == plane.reshape(-1)[0])


def test_cli_renders_jpeg_textured_glb(tmp_path, capsys):
    """That glb through both CLIs (48x32, 2 spp, max bounces 1024): the
    image gate of tests/test_torch_offline.py."""
    from chip_smoke import cornell_jpeg_glb
    from moonshine_tpu.io.exr import read_exr as jax_read_exr
    from moonshine_tpu.render import offline as JO
    from moonshine_tpu_torch.io.exr import read_exr, write_exr
    from moonshine_tpu_torch.render import offline as PO
    from test_torch_render import assert_image_close

    (tmp_path / "c.glb").write_bytes(cornell_jpeg_glb(
        (FIXTURES / "baseline_420.jpg").read_bytes()))
    write_exr(tmp_path / "sky.exr", np.full((4, 8, 3), 0.5, np.float32))
    args = [str(tmp_path / "c.glb"), str(tmp_path / "sky.exr")]
    size = ["--width", "48", "--height", "32", "--spp", "2"]
    assert JO.main(args + [str(tmp_path / "j.exr")] + size) == 0
    assert PO.main(args + [str(tmp_path / "p.exr")] + size,
                   device="cpu") == 0
    capsys.readouterr()
    got = read_exr(tmp_path / "p.exr")[..., :3]
    assert_image_close(got, jax_read_exr(tmp_path / "j.exr")[..., :3])


# --- DDS (mirrors tests/test_frontends.py TestDds) ---

def build_dds(dxgi=71, w=64, h=32, mips=3):
    hdr = struct.pack("<I", PD.DDS_MAGIC)
    header = bytearray(124)
    struct.pack_into("<3I", header, 0, 124, 0x1007, h)
    struct.pack_into("<I", header, 12, w)
    struct.pack_into("<I", header, 24, mips)
    struct.pack_into("<II4s", header, 72, 32, 0x4, b"DX10")
    dx10 = struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return hdr + bytes(header) + dx10 + b"\x00" * 64


@pytest.mark.parametrize("dxgi", sorted(JD.DXGI_FORMATS))
def test_dds_parse_matches_reference(dxgi):
    data = build_dds(dxgi=dxgi, w=48, h=16, mips=0)
    got, want = PD.parse_header(data), JD.parse_header(data)
    assert vars(got) == vars(want)
    assert (got.width, got.height, got.mip_count) == (48, 16, 1)


def test_dds_parse():
    h = PD.parse_header(build_dds())
    assert (h.width, h.height, h.mip_count) == (64, 32, 3)
    assert h.format_name == "bc1_rgba_unorm"


@pytest.mark.parametrize("data", [b"nope" * 64, build_dds(dxgi=10),
                                  build_dds()[:100]])
def test_dds_rejects(data):
    with pytest.raises(ValueError):
        JD.parse_header(data)
    with pytest.raises(ValueError):
        PD.parse_header(data)
