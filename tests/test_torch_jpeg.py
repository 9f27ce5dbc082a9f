"""The port's JPEG decoder (io/jpeg.py) against PIL's
`Image.open(...).convert("RGBA")`, which is what the JAX package's glTF
loader calls (PIL here is built on libjpeg-turbo), bit for bit: JPEGs
that PIL writes inside the test (baseline 4:4:4 / 4:2:2 / 4:2:0,
grayscale, progressive, optimised Huffman tables, restart markers, odd
sizes down to 1x1) and JPEGs a hand encoder below writes where PIL
cannot (4:4:0 and 4:1:1 sampling, RGB component ids, restart intervals
across interleaved MCUs, coefficients large enough to hit the IDCT's
range-limit wrap); the kinds added since: 4-component CMYK (PIL writes
it) and YCCK (hand-encoded with an Adobe marker), 8-bit lossless files
(a lossless encoder below: predictors 1-7, point transforms, restarts,
subsampling, separate scans), arithmetic-coded sequential and
progressive files (scripts/time_jpeg.py's `arith_jpeg`, held also
against PIL's decode of the same coefficients Huffman-coded), and
progressive files whose script stops short, where libjpeg-turbo's block
smoothing runs; the committed fixtures of tests/torch_fixtures/ (the
ones the card's smoke run decodes) against their PIL goldens; a glb
with a JPEG texture through both packages' loaders and CLIs; the kinds
that PIL refuses as well, refused by both; and the DDS header parser
against the reference's (mirroring tests/test_frontends.py:223-245)."""

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
from moonshine_tpu_torch.scripts import time_jpeg
from moonshine_tpu_torch.scripts.time_jpeg import (
    ArithEncoder, BitWriter, arith_jpeg, hand_jpeg, segment,
)

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


# --- four components: CMYK (PIL writes it, Adobe transform 0) and YCCK
# (hand-encoded, Adobe transform 2) ---

def with_adobe(data: bytes, transform: int) -> bytes:
    """`data` with an Adobe APP14 segment (the given colour transform)
    after SOI."""
    return data[:2] + segment(0xEE, b"Adobe" + bytes(
        [0, 100, 0, 0, 0, 0, transform])) + data[2:]


@pytest.mark.parametrize("w,h,quality", [(24, 16, 90), (37, 53, 75),
                                         (1, 1, 95), (9, 5, 50)])
def test_cmyk_matches_pil(w, h, quality):
    a = np.random.RandomState(w * h).randint(0, 256, (h, w, 4))
    buf = io.BytesIO()
    Image.fromarray(a.astype(np.uint8), "CMYK").save(buf, "JPEG",
                                                     quality=quality)
    data = buf.getvalue()
    im = Image.open(io.BytesIO(data))
    assert im.mode == "CMYK" and im.info.get("adobe_transform") == 0
    np.testing.assert_array_equal(PJ.decode_jpeg(data), pil_rgba(data))


FOUR_CASES = {
    "ycck_420": ([(2, 2), (1, 1), (1, 1), (2, 2)], 2),
    "ycck_444": ([(1, 1)] * 4, 2),
    "ycck_transform1_422": ([(2, 1), (1, 1), (1, 1), (2, 1)], 1),
    "cmyk_adobe0_444": ([(1, 1)] * 4, 0),
    "cmyk_no_marker_420": ([(2, 2), (1, 1), (1, 1), (2, 2)], None),
}


@pytest.mark.parametrize("name", sorted(FOUR_CASES))
def test_four_components_match_pil(name):
    """YCCK (Adobe transform 2, and 1, which libjpeg also takes as YCCK),
    CMYK with transform 0 and with no Adobe marker at all."""
    sampling, transform = FOUR_CASES[name]
    data = hand_jpeg(29, 21, sampling, seed=len(name), ids=(1, 2, 3, 4))
    if transform is not None:
        data = with_adobe(data, transform)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"
    np.testing.assert_array_equal(PJ.decode_jpeg(data), pil_rgba(data))


# --- lossless (SOF3): a Huffman lossless encoder ---

_PREDICTORS = {
    1: lambda ra, rb, rc: ra, 2: lambda ra, rb, rc: rb,
    3: lambda ra, rb, rc: rc, 4: lambda ra, rb, rc: ra + rb - rc,
    5: lambda ra, rb, rc: ra + ((rb - rc) >> 1),
    6: lambda ra, rb, rc: rb + ((ra - rc) >> 1),
    7: lambda ra, rb, rc: (ra + rb) >> 1,
}


def lossless_jpeg(planes, psv, pt=0, sampling=None, restart=0, ids=None,
                  marker=None, interleave=True) -> bytes:
    """An 8-bit lossless JPEG (SOF3) of uint8 component planes (each at
    its own sampled size) with predictor `psv` and point transform `pt`:
    T.81 Annex H's prediction (the first row from the left, a row's first
    sample from above, the predictor restarting where a restart interval
    begins), differences modulo 2^16 Huffman-coded with every category
    five bits long. marker: "jfif", or an Adobe transform."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax = max(x[0] for x in sampling)
    vmax = max(x[1] for x in sampling)
    height = max(p.shape[0] * vmax // x[1] for p, x in zip(planes, sampling))
    width = max(p.shape[1] * hmax // x[0] for p, x in zip(planes, sampling))
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, marker]))
    sof = struct.pack(">BHHB", 8, height, width, nc)
    for i, (ch, cv) in enumerate(sampling):
        sof += bytes([ids[i], (ch << 4) | cv, 0])
    out += segment(0xC3, sof)
    counts = [0] * 16
    counts[4] = 17  # categories 0-16, five bits each
    out += segment(0xC4, bytes([0x00] + counts) + bytes(range(17)))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    scans = [list(range(nc))] if interleave else [[i] for i in range(nc)]
    for comps in scans:
        if len(comps) == 1:
            ci = comps[0]
            rows, cols = planes[ci].shape
            units = [[(ci, r, x)] for r in range(rows) for x in range(cols)]
            reset = {ci: {r for r in range(rows)
                          if restart and (r * cols) % restart == 0}}
        else:
            units = [[(ci, my * sampling[ci][1] + v, mx * sampling[ci][0] + hh)
                      for ci in comps for v in range(sampling[ci][1])
                      for hh in range(sampling[ci][0])]
                     for my in range(mcuy) for mx in range(mcux)]
            reset = {ci: {my * sampling[ci][1] for my in range(mcuy)
                          if restart and (my * mcux) % restart == 0}
                     for ci in comps}
        diffs = {}
        for ci in comps:
            x = planes[ci].astype(np.int64) >> pt
            d = np.zeros_like(x)
            for r in range(x.shape[0]):
                for c in range(x.shape[1]):
                    if r == 0 or r in reset[ci]:
                        pred = (1 << (7 - pt)) if c == 0 else x[r, c - 1]
                    elif c == 0:
                        pred = x[r - 1, 0]
                    else:
                        pred = _PREDICTORS[psv](int(x[r, c - 1]),
                                                int(x[r - 1, c]),
                                                int(x[r - 1, c - 1]))
                    d[r, c] = (int(x[r, c]) - pred) & 0xFFFF
            diffs[ci] = d
        sos = bytes([len(comps)]) + b"".join(bytes([ids[i], 0])
                                             for i in comps)
        out += segment(0xDA, sos + bytes([psv, 0, pt]))
        bw = BitWriter()
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            for ci, r, c in unit:
                d = diffs[ci]
                dv = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] else 0
                v = dv - 65536 if dv > 32768 else dv
                if v == 32768:
                    bw.put(16, 5)
                    continue
                cat = abs(v).bit_length()
                bw.put(cat, 5)
                if cat:
                    bw.put(v if v >= 0 else v + (1 << cat) - 1, cat)
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


def plane(h, w, seed):
    """A blocky uint8 plane with noise: small differences and large."""
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(base, np.ones((4, 4)))[:h, :w] + rs.randint(-6, 7, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 2])
def test_lossless_grey_matches_pil(psv, pt):
    """Each predictor and two point transforms: PIL's texels are the
    source's (lossless) and the port's are PIL's."""
    g = (plane(23, 31, psv) >> pt) << pt
    data = lossless_jpeg([g], psv, pt)
    want = pil_rgba(data)
    np.testing.assert_array_equal(want[..., 0], g)
    np.testing.assert_array_equal(PJ.decode_jpeg(data), want)


LOSSLESS_CASES = {
    "rgb_adobe0": dict(n=3, psv=4, marker=0),
    "rgb_no_marker": dict(n=3, psv=5),
    "rgb_ids": dict(n=3, psv=6, ids=[82, 71, 66]),
    "separate_scans": dict(n=3, psv=6, pt=1, marker=0, interleave=False),
    "sampled_420": dict(n=3, psv=7, marker=0,
                        sampling=[(2, 2), (1, 1), (1, 1)]),
    "sampled_422_scans": dict(n=3, psv=2, marker=0, interleave=False,
                              sampling=[(2, 1), (1, 1), (1, 1)]),
    "cmyk": dict(n=4, psv=1, marker=0),
    "restart_rows_grey": dict(n=1, psv=5, restart=26),
    "restart_two_rows_rgb": dict(n=3, psv=3, marker=0, restart=52),
}


@pytest.mark.parametrize("name", sorted(LOSSLESS_CASES))
def test_lossless_colour_matches_pil(name):
    """RGB (by an Adobe marker, by no marker at all, which libjpeg-turbo
    takes as RGB for lossless files, by 'R','G','B' ids), separate scans,
    subsampled planes (replicated: no fancy upsampling of one-sample
    blocks), CMYK, restart intervals of whole MCU rows."""
    kw = dict(LOSSLESS_CASES[name])
    n = kw.pop("n")
    sampling = kw.get("sampling") or [(1, 1)] * n
    hmax = max(x[0] for x in sampling)
    vmax = max(x[1] for x in sampling)
    planes = [plane(20 * x[1] // vmax, 26 * x[0] // hmax, i)
              for i, x in enumerate(sampling)]
    data = lossless_jpeg(planes, **kw)
    np.testing.assert_array_equal(PJ.decode_jpeg(data), pil_rgba(data))


# --- arithmetic coding (SOF9, SOF10, DAC): scripts/time_jpeg.py's encoder

ARITH_CASES = {
    "420_37x29": dict(w=37, h=29, sampling=[(2, 2), (1, 1), (1, 1)]),
    "grey_37x29": dict(w=37, h=29, sampling=[(1, 1)]),
    "422_restart_64x40": dict(w=64, h=40, sampling=[(2, 1), (1, 1), (1, 1)],
                              restart=3),
    "444_big_40x33": dict(w=40, h=33, sampling=[(1, 1)] * 3, big=True),
    "440_1x1": dict(w=1, h=1, sampling=[(1, 2), (1, 1), (1, 1)]),
}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("dac", [False, True])
@pytest.mark.parametrize("name", sorted(ARITH_CASES))
def test_arithmetic_matches_pil(name, progressive, dac):
    """Sequential and progressive (DC and AC first scans and every
    refinement), the default conditioning and DAC's (L = 2, U = 5,
    K = 2): PIL decodes the file to what it decodes the same
    coefficients Huffman-coded to, and the port decodes it to PIL's."""
    kw = ARITH_CASES[name]
    data = arith_jpeg(**kw, seed=len(name), progressive=progressive,
                      dac={(0, 0): 0x52, (1, 0): 2} if dac else None)
    want = pil_rgba(data)
    np.testing.assert_array_equal(want, pil_rgba(hand_jpeg(**kw,
                                                           seed=len(name))))
    np.testing.assert_array_equal(PJ.decode_jpeg(data), want)


def test_arith_encoder_carries():
    """The encoder's carry into stacked 0xFF bytes: a long run of one
    probable symbol then an improbable one, decoded back by io/jpeg.py's
    arithmetic decoder."""
    bits = [0] * 4000 + [1] + [0] * 500 + [1, 1, 0, 1] * 50
    enc = ArithEncoder()
    st = [0]
    for b in bits:
        enc.encode(st, 0, b)
    data = enc.finish()
    dec = PJ._ArithDecoder(data.replace(b"\xff\x00", b"\xff"))
    st = [0]
    assert [dec.decode(st, 0) for _ in bits] == bits


# --- block smoothing: progressive scripts that stop short ---

def smoothing_scripts(nc):
    every = range(nc)
    return {
        "dc_only": [(every, 0, 0, 0, 1)],
        "ac_first_only": [(every, 0, 0, 0, 0)]
        + [([c], 1, 5, 0, 2) for c in every]
        + [([c], 6, 63, 0, 1) for c in every],
        "ac_1_2": [(every, 0, 0, 0, 1)] + [([c], 1, 2, 0, 1) for c in every],
        "exact_1_9": [(every, 0, 0, 0, 0)] + [([c], 1, 9, 0, 0)
                                               for c in every],
    }


SMOOTH_SAMPLINGS = {"grey": [(1, 1)], "grey_v2": [(1, 2)],
                    "420": [(2, 2), (1, 1), (1, 1)],
                    "440": [(1, 2), (1, 1), (1, 1)],
                    "ycck_v3": [(1, 3), (1, 1), (1, 1), (1, 3)]}


@pytest.mark.parametrize("script", ["dc_only", "ac_first_only", "ac_1_2",
                                    "exact_1_9"])
@pytest.mark.parametrize("samp", sorted(SMOOTH_SAMPLINGS))
@pytest.mark.parametrize("size", [(16, 40), (61, 45), (40, 40)])
def test_block_smoothing_matches_pil(samp, script, size):
    """libjpeg-turbo smooths the blocks of a progressive file whose
    coefficients 1-9 are not known exactly (never sent: the DC-only
    kernel, which moves the DC too; or sent with a point transform left):
    the port's decode is PIL's, the image edges, narrow images and the
    dummy blocks that pad the last iMCU row included. exact_1_9 sends
    1-9 exactly, where no smoothing runs."""
    sampling = SMOOTH_SAMPLINGS[samp]
    w, h = size
    data = arith_jpeg(w, h, sampling, seed=w + h, progressive=True,
                      ids=(1, 2, 3, 4),
                      script=smoothing_scripts(len(sampling))[script])
    np.testing.assert_array_equal(PJ.decode_jpeg(data), pil_rgba(data))


@pytest.mark.parametrize("keep", [1, 3, 5, 8])
def test_block_smoothing_huffman_progressive(keep):
    """A PIL progressive file cut to its first `keep` scans (Huffman):
    smoothing runs alike."""
    data = pil_jpeg(48, 40, seed=keep, progressive=True, quality=80)
    cut = data.index(b"\xff\xda")
    for _ in range(keep):
        cut = data.index(b"\xff\xda", cut + 2)
    np.testing.assert_array_equal(
        PJ.decode_jpeg(data[:cut] + b"\xff\xd9"),
        pil_rgba(data[:cut] + b"\xff\xd9"))


def test_time_jpeg_entry_point(capsys):
    """scripts/time_jpeg.py at 64x64: both codings decode to the same
    texels."""
    out = time_jpeg.main(["--size", "64", "--reps", "1"])
    capsys.readouterr()
    assert out["same_texels"] and len(out["cases"]) == 2
    assert out["cases"][1]["coding"].startswith("arithmetic")


# --- the committed fixtures (decoded on the card's host by the smoke) ---

FIXTURE_NAMES = ["arith_prog_422", "arith_restart_420", "baseline_420",
                 "cmyk_444", "grey_restart", "lossless_rgb_p6",
                 "progressive_422", "smooth_dc_only_420",
                 "smooth_partial_420", "ycck_420"]


def fixture_bytes(name: str) -> bytes:
    """How each fixture added with the JPEG kinds was written (the earlier
    three came from PIL directly)."""
    if name == "cmyk_444":
        a = np.random.RandomState(9).randint(0, 256, (16, 24, 4))
        buf = io.BytesIO()
        Image.fromarray(a.astype(np.uint8), "CMYK").save(buf, "JPEG",
                                                         quality=90)
        return buf.getvalue()
    if name == "ycck_420":
        return with_adobe(hand_jpeg(29, 21, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                    seed=4, ids=(1, 2, 3, 4)), 2)
    if name == "lossless_rgb_p6":
        return lossless_jpeg([plane(20, 26, i) for i in range(3)], 6, 1,
                             marker=0, restart=26)
    if name == "arith_restart_420":
        return arith_jpeg(37, 29, [(2, 2), (1, 1), (1, 1)], seed=5,
                          restart=3, dac={(0, 0): 0x52, (1, 0): 2})
    if name == "arith_prog_422":
        return arith_jpeg(40, 33, [(2, 1), (1, 1), (1, 1)], seed=6,
                          progressive=True)
    scripts = smoothing_scripts(3)
    return arith_jpeg(61, 45, [(2, 2), (1, 1), (1, 1)], seed=7,
                      progressive=True,
                      script=scripts["dc_only" if "dc_only" in name
                                     else "ac_1_2"])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixtures(name):
    """The fixtures the card's smoke run decodes: PIL's RGBA of each is
    its committed golden, and the port decodes to it; the ones added with
    the new kinds are what `fixture_bytes` writes."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    gold = np.load(FIXTURES / f"{name}.npy")
    np.testing.assert_array_equal(pil_rgba(data), gold)
    np.testing.assert_array_equal(PJ.decode_jpeg(data), gold)
    if name not in ("baseline_420", "progressive_422", "grey_restart"):
        assert fixture_bytes(name) == data


# --- what PIL refuses, the port refuses ---

def _sof_patched(marker: int, precision: int = 8) -> bytes:
    """A PIL baseline file with its SOF0 marker (and precision) changed."""
    data = bytearray(pil_jpeg(8, 8))
    i = data.index(b"\xff\xc0")
    data[i + 1] = marker
    data[i + 4] = precision
    return bytes(data)


def _lossless_arith() -> bytes:
    """A valid 12x7 lossless arithmetic-coded file (SOF11) of a constant
    128 grey: every difference zero, one decision each in one bin."""
    enc = ArithEncoder()
    st = [0]
    for _ in range(12 * 7):
        enc.encode(st, 0, 0)
    return (b"\xff\xd8" + segment(0xCB, struct.pack(">BHHB", 8, 7, 12, 1)
                                  + bytes([1, 0x11, 0]))
            + segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + enc.finish()
            + b"\xff\xd9")


REFUSED = {
    "12-bit": (lambda: _sof_patched(0xC1, 12), "12-bit"),
    "hierarchical": (lambda: _sof_patched(0xC5), "hierarchical"),
    "lossless_arithmetic": (_lossless_arith, "lossless arithmetic"),
    "two_components": (lambda: hand_jpeg(16, 16, [(1, 1), (1, 1)], seed=1),
                       "2-component"),
    "fractional_sampling": (lambda: hand_jpeg(24, 16, [(3, 1), (2, 1),
                                                       (1, 1)], seed=2),
                            "non-integer sampling"),
    "lossless_ycbcr": (lambda: lossless_jpeg([plane(8, 8, i)
                                              for i in range(3)], 4,
                                             marker="jfif"),
                       "colour conversion"),
    "lossless_ycck": (lambda: lossless_jpeg([plane(8, 8, i)
                                             for i in range(4)], 1,
                                            marker=2), "colour conversion"),
    "lossless_partial_row_restart": (
        lambda: lossless_jpeg([plane(16, 10, 5)], 5, restart=7),
        "restart intervals"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_unsupported_kinds_raise(kind):
    """The kinds the port does not read are the ones PIL (libjpeg-turbo
    3.1) does not read either: both refuse each file."""
    make, reason = REFUSED[kind]
    data = make()
    with pytest.raises(OSError):
        pil_rgba(data)
    with pytest.raises(NotImplementedError, match=reason):
        PJ.decode_jpeg(data, kind)


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
