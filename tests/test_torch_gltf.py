"""glTF ingest: the same glb / gltf bytes through moonshine_tpu's loader
and the port's give equal flattened scene arrays and equal lenses; the
port's PNG decoder equals PIL's `convert("RGBA") / 255` (the JAX
package's texture decode) for every colour type, bit depth, filter and
transparency form, interlaced (Adam7) files included; a JPEG texture
of a kind the port does not read raises (tests/test_torch_jpeg.py holds
the JPEG decoder against PIL)."""

import base64
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from moonshine_tpu.scene import gltf as JG
from moonshine_tpu_torch.io import png as PNG
from moonshine_tpu_torch.scene import gltf as PG

from chip_smoke import repack_glb
from glb_builder import build_glb, cornell_box_glb
from test_torch_scene import ENV_KEYS, ENV_TOL, jax_scene_arrays


# --- PNG files ---

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def encode_png(samples, color_type, depth, filters=(0,), palette=None,
               trns=None, interlace=0) -> bytes:
    """A PNG of integer samples [H, W, C], row y filtered with
    filters[y % len(filters)] (0-4), its IDAT split in two chunks; the
    PNG spec's encoder, written out so that 16-bit colour, sub-byte
    depths and Adam7 interlacing (interlace=1: the seven reduced images
    one after another, each filtered on its own, empty ones left out),
    which PIL cannot write, are covered too."""
    s = np.asarray(samples)
    h, w, _ = s.shape
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b"".join(_filtered(s[y0::dy, x0::dx], depth, filters)
                    for x0, y0, dx, dy in passes if x0 < w and y0 < h)
    z = zlib.compress(data)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        png += _chunk(b"tRNS", trns)
    return (png + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def _filtered(s, depth, filters) -> bytes:
    """Scanlines of samples [H, W, C], each led by its filter type."""
    h = s.shape[0]
    if depth == 16:
        raw = s.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        raw = s.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        flat = s.reshape(h, -1).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        shifts = (np.arange(per - 1, -1, -1) * depth).astype(np.uint8)
        raw = (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    bpp = max(1, s.shape[2] * depth // 8)
    out, prev = bytearray(), np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        row = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0 * row, a, prev, (a + prev) // 2, paeth][f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def pil_png(array, **save) -> bytes:
    """PNG bytes from PIL; the mode follows the array (uint8 [H, W] L,
    [H, W, 2|3|4] LA / RGB / RGBA, uint16 [H, W] I;16)."""
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG", **save)
    return buf.getvalue()


def pil_rgba(png: bytes) -> np.ndarray:
    img = Image.open(io.BytesIO(png)).convert("RGBA")
    return np.asarray(img, np.float32) / 255.0


def _rs(seed):
    return np.random.RandomState(seed)


def _pil_cases():
    rs = _rs(0)
    pal = Image.fromarray(rs.randint(0, 6, (7, 9)).astype(np.uint8)).convert(
        "P")
    pal.putpalette(list(rs.randint(0, 256, 18)))
    buf = io.BytesIO()
    pal.save(buf, format="PNG", transparency=bytes([0, 128, 255, 9]))
    return {
        "rgb": pil_png(rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)),
        "rgba": pil_png(rs.randint(0, 256, (6, 5, 4)).astype(np.uint8)),
        "grey": pil_png(rs.randint(0, 256, (5, 8)).astype(np.uint8)),
        "grey_alpha": pil_png(rs.randint(0, 256, (5, 8, 2)).astype(np.uint8)),
        "palette_trns": buf.getvalue(),
        "grey16": pil_png(rs.randint(0, 65536, (6, 7)).astype(np.uint16)),
        "grey_key": pil_png(np.arange(12, dtype=np.uint8).reshape(3, 4),
                            transparency=5),
        "rgb_key": pil_png(np.tile(np.uint8([[[1, 2, 3], [4, 5, 6]]]),
                                   (2, 2, 1)), transparency=(4, 5, 6)),
    }


def _spec_cases():
    rs = _rs(1)
    every_filter = (0, 1, 2, 3, 4)
    cases = {
        "rgb16": encode_png(rs.randint(0, 65536, (9, 6, 3)), 2, 16,
                            every_filter),
        "rgba16": encode_png(rs.randint(0, 65536, (7, 5, 4)), 6, 16,
                             (4, 3, 1)),
        "grey_alpha16": encode_png(rs.randint(0, 65536, (6, 5, 2)), 4, 16,
                                   every_filter),
        "grey16_key": encode_png(np.array([[[5], [300], [255]]]), 0, 16,
                                 trns=struct.pack(">H", 5)),
        "rgb16_key": encode_png(np.array([[[1025, 1286, 1541], [4, 5, 6]]]),
                                2, 16, trns=struct.pack(">HHH", 4, 5, 6)),
        "rgb8_filters": encode_png(rs.randint(0, 256, (11, 13, 3)), 2, 8,
                                   every_filter),
        "rgba8_filters": encode_png(rs.randint(0, 256, (10, 3, 4)), 6, 8,
                                    (3, 4, 2, 1, 0)),
        "palette_short": encode_png(np.array([[[0], [1], [2], [3]]]), 3, 8,
                                    palette=[[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                                    trns=bytes([7])),
    }
    for d in (1, 2, 4):
        cases[f"grey{d}"] = encode_png(rs.randint(0, 2 ** d, (5, 11, 1)), 0,
                                       d, every_filter,
                                       trns=struct.pack(">H", 1))
        cases[f"palette{d}"] = encode_png(
            rs.randint(0, 2 ** d, (4, 13, 1)), 3, d, every_filter,
            palette=rs.randint(0, 256, (2 ** d, 3)))
    return cases


PNG_CASES = {**_pil_cases(), **_spec_cases()}


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_decoder_matches_pil(name):
    data = PNG_CASES[name]
    got = PNG.png_rgba(data, name)
    want = pil_rgba(data)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _interlaced_cases():
    """Adam7 files of every colour type and bit depth the decoder takes,
    at sizes whose reduced images are partly empty (1x1, 3x2) or ragged
    (13x11, 17x9), with every filter and the tRNS forms."""
    rs = _rs(2)
    every_filter = (0, 1, 2, 3, 4)
    forms = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
             6: (8, 16)}
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
    cases = {}
    for ctype, depths in forms.items():
        for depth in depths:
            for h, w in ((13, 11), (1, 1), (3, 2), (9, 17)):
                top = 2 ** depth
                samples = rs.randint(0, top, (h, w, channels[ctype]))
                kw = {}
                if ctype == 3:
                    kw = dict(palette=rs.randint(0, 256, (min(top, 40), 3)),
                              trns=bytes(rs.randint(0, 256, 5)))
                elif ctype == 0:
                    kw = dict(trns=struct.pack(">H", int(samples[0, 0, 0])))
                elif ctype == 2:
                    kw = dict(trns=struct.pack(">HHH", *samples[-1, -1]))
                cases[f"adam7_c{ctype}_d{depth}_{h}x{w}"] = encode_png(
                    samples, ctype, depth, every_filter, interlace=1, **kw)
    return cases


INTERLACED_CASES = _interlaced_cases()


@pytest.mark.parametrize("name", sorted(INTERLACED_CASES))
def test_png_decoder_matches_pil_interlaced(name):
    """Adam7 files built by the hand encoder (PIL writes none) decode to
    PIL's texels."""
    data = INTERLACED_CASES[name]
    assert data[28] == 1  # IHDR's interlace method
    np.testing.assert_array_equal(PNG.png_rgba(data, name), pil_rgba(data))


def test_png_rejects_interlaced_and_jpeg():
    """A JPEG texture of a kind io/jpeg.py does not read (arithmetic
    coding) raises naming the image, and a bad CRC raises; interlaced
    files decode (test_png_decoder_matches_pil_interlaced), and so do
    the JPEG kinds tests/test_torch_jpeg.py covers."""
    data = encode_png(np.zeros((2, 2, 3)), 2, 8, interlace=1)
    arithmetic = (b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x02\x00\x02\x01"
                  b"\x01\x11\x00\xff\xd9")
    glb = textured_glb(extra_images=[arithmetic])
    doc, binary = unpack_glb(glb)
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": len(doc["images"]) - 1}
    with pytest.raises(NotImplementedError,
                       match=r"glTF image 5 .*arithmetic coding"):
        PG.world_from_glb(repack_glb(doc, binary))
    with pytest.raises(ValueError, match="CRC"):
        PNG.decode_png(data[:20] + bytes([data[20] ^ 1]) + data[21:])


# --- scenes through both loaders ---

def unpack_glb(glb: bytes):
    g = JG.Glb.parse(glb)
    return json.loads(json.dumps(g.json)), bytes(g.binary)


def textured_glb(extra_images=()):
    """Two textured quads (base colour RGB, metal-rough RGBA, normal grey,
    emissive palette+tRNS; a 16-bit grey base colour), a Lambert emitter
    and a mirror, under a parent node with rotation and scale, and a
    camera."""
    cases = _pil_cases()
    images = [cases["rgb"], cases["rgba"], cases["grey"],
              cases["palette_trns"], cases["grey16"], *extra_images]
    quad_p = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    quad_uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
    quad_i = np.uint16([[0, 1, 2], [0, 2, 3]])
    materials = [
        {"name": "painted", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1}},
         "normalTexture": {"index": 2}, "emissiveTexture": {"index": 3}},
        {"name": "grey16", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 4}, "metallicFactor": 0.25,
            "roughnessFactor": 0.5},
         "extensions": {"KHR_materials_ior": {"ior": 1.33}}},
        {"name": "EmitterPanel", "pbrMetallicRoughness": {
            "baseColorFactor": [0, 0, 0, 1], "metallicFactor": 0.0,
            "roughnessFactor": 1.0}, "emissiveFactor": [1.0, 0.5, 0.25],
         "extensions": {"KHR_materials_emissive_strength": {
             "emissiveStrength": 4.0}}},
        {"name": "mirror", "pbrMetallicRoughness": {
            "metallicFactor": 1.0, "roughnessFactor": 0.0}},
        {"name": "glass", "extensions": {
            "KHR_materials_transmission": {"transmissionFactor": 1.0},
            "KHR_materials_ior": {"ior": 1.6}}},
    ]
    meshes = [dict(positions=quad_p, indices=quad_i, texcoords=quad_uv,
                   material=m) for m in range(5)]
    meshes[3]["normals"] = np.tile(np.float32([0, 0, 1]), (4, 1))
    nodes = [
        {"children": [1, 2], "rotation": [0.0, 0.38268343, 0.0, 0.9238795],
         "scale": [2.0, 1.0, 0.5], "translation": [0.5, -1.0, 2.0]},
        {"mesh": 0, "translation": [0.0, 0.0, -3.0]},
        {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 0, -1, 0, 0, 1, 0, 0,
                               3, 1, -4, 1]},
        {"mesh": 2, "translation": [0.0, 2.5, -3.0],
         "rotation": [0.70710677, 0.0, 0.0, 0.70710677]},
        {"mesh": 3, "translation": [-3.0, 0.0, -5.0]},
        {"mesh": 4, "scale": [0.5, 0.5, 0.5]},
        {"camera": 0, "translation": [0.2, 0.5, 6.0],
         "rotation": [0.0, 0.0436194, 0.0, 0.9990482]},
    ]
    cameras = [{"type": "perspective",
                "perspective": {"yfov": 0.8, "znear": 0.01}}]
    return build_glb(meshes, materials, nodes, cameras, images)


def sparse_glb():
    """The Cornell glb with a sparse overlay moving two floor corners, and
    its light's positions read through a strided bufferView."""
    doc, binary = unpack_glb(cornell_box_glb())
    binary = bytearray(binary)

    def add_view(arr, stride=None):
        binary.extend(b"\x00" * (-len(binary) % 4))
        view = {"buffer": 0, "byteOffset": len(binary),
                "byteLength": arr.nbytes}
        if stride:
            view["byteStride"] = stride
        binary.extend(arr.tobytes())
        doc["bufferViews"].append(view)
        return len(doc["bufferViews"]) - 1

    floor = doc["meshes"][0]["primitives"][0]["attributes"]["POSITION"]
    doc["accessors"][floor]["sparse"] = {
        "count": 2,
        "indices": {"bufferView": add_view(np.uint16([1, 3])),
                    "componentType": 5123},
        "values": {"bufferView": add_view(
            np.float32([[1.2, -1, -1.1], [-1.1, -1, 1.3]]))},
    }
    light = doc["meshes"][5]["primitives"][0]["attributes"]["POSITION"]
    acc = doc["accessors"][light]
    pos = np.frombuffer(bytes(binary), np.float32, acc["count"] * 3,
                        doc["bufferViews"][acc["bufferView"]]["byteOffset"])
    interleaved = np.zeros((acc["count"], 5), np.float32)
    interleaved[:, :3] = pos.reshape(-1, 3)
    acc["bufferView"] = add_view(interleaved, stride=20)
    return repack_glb(doc, bytes(binary))


def gltf_files(tmp_path, glb: bytes, data_uris: bool):
    """The glb as .gltf JSON with its buffer and images as sibling files or
    as data: URIs; returns the .gltf path."""
    doc, binary = unpack_glb(glb)
    images = []
    for img in doc.get("images", []):
        view = doc["bufferViews"][img.pop("bufferView")]
        off = view.get("byteOffset", 0)
        images.append(binary[off:off + view["byteLength"]])
    for i, (img, data) in enumerate(zip(doc.get("images", []), images)):
        if data_uris:
            img["uri"] = ("data:image/png;base64,"
                          + base64.b64encode(data).decode())
        else:
            img["uri"] = f"tex {i}.png"
            (tmp_path / f"tex {i}.png").write_bytes(data)
    if data_uris:
        doc["buffers"] = [{"byteLength": len(binary), "uri": (
            "data:application/octet-stream;base64,"
            + base64.b64encode(binary).decode())}]
    else:
        (tmp_path / "scene.bin").write_bytes(binary)
        doc["buffers"] = [{"byteLength": len(binary), "uri": "scene.bin"}]
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(doc))
    return path


def assert_same_world(jworld, pworld):
    want, want_s = jax_scene_arrays(jworld.build())
    got, got_s = pworld.build_arrays()
    assert set(want) <= set(got)
    for key, w in want.items():
        g = got[key]
        if key.startswith("mat_atlas."):  # bf16 planes, rounded on the device
            g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
        assert g.shape == w.shape, key
        if key in ENV_KEYS:
            np.testing.assert_allclose(g, w, **ENV_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=key)
    for key, w in want_s.items():
        if key == "env.integral":
            assert got_s[key] == pytest.approx(w, rel=1e-6)
        else:
            assert got_s[key] == w, key


def assert_same_lens(src):
    want, got = JG.lens_from_glb(src), PG.lens_from_glb(src)
    for f in ("origin", "forward", "up"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.vfov, got.aperture, got.focus_distance) == (
        want.vfov, want.aperture, want.focus_distance)


@pytest.mark.parametrize("scene", ["cornell", "textured", "sparse"])
def test_glb_matches_reference(scene, tmp_path):
    glb = {"cornell": cornell_box_glb, "textured": textured_glb,
           "sparse": sparse_glb}[scene]()
    path = tmp_path / "scene.glb"
    path.write_bytes(glb)
    for src in (glb, path):
        assert_same_world(JG.world_from_glb(src), PG.world_from_glb(src))
        assert_same_lens(src)
    if scene == "sparse":  # the overlay really moved the floor
        plain = PG.world_from_glb(cornell_box_glb()).meshes[0].positions
        moved = PG.world_from_glb(glb).meshes[0].positions
        assert (plain != moved).any(1).sum() == 2


@pytest.mark.parametrize("data_uris", [False, True])
def test_gltf_with_external_and_data_uris(tmp_path, data_uris):
    path = gltf_files(tmp_path, textured_glb(), data_uris)
    assert_same_world(JG.world_from_glb(path), PG.world_from_glb(path))
    assert_same_lens(path)


def test_spec_channels_and_helpers():
    glb = textured_glb()
    for spec in (True, False):
        j = JG.world_from_glb(glb, spec_channels=spec).materials[0]
        p = PG.world_from_glb(glb, spec_channels=spec).materials[0]
        np.testing.assert_array_equal(p.variant.metalness,
                                      j.variant.metalness)
    c = np.linspace(0, 1, 101, dtype=np.float32)
    np.testing.assert_array_equal(PG.srgb_to_linear(c), JG.srgb_to_linear(c))
    doc = unpack_glb(glb)[0]
    for g, w in zip(PG._node_transforms(doc), JG._node_transforms(doc)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(PG._zup(g), JG._zup(w))
    with pytest.raises(ValueError, match="no camera"):
        PG.lens_from_glb(build_glb([], [], []))
