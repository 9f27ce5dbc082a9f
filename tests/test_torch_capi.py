"""The port's C ABI (moonshine_tpu_torch/capi.py, native/engine_shim.cpp,
native/build.py) on the CPU: capi's flat functions against the port's
Engine, the header against the JAX package's, the library built and
driven by the C++ host and by the mock Hydra session
(native/hydra/test_hydra_core.cpp, compiled from its place, unedited),
and the EXR entry points through io/exr.py. Hosts run with
MSN_PLATFORM=cpu; each subprocess has its own timeout."""

import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from moonshine_tpu_torch import capi
from moonshine_tpu_torch.engine.engine import Engine
from moonshine_tpu_torch.io import exr
from moonshine_tpu_torch.native import build
from moonshine_tpu_torch.scene.types import Lens

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADER = ROOT / "native" / "moonshine_tpu.h"
HYDRA = ROOT / "native" / "hydra"

# native/test_shim.cpp's scene: a ground quad under a white sky
QUAD = np.float32([[-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]])
QUAD_IDX = np.uint32([[0, 1, 2], [0, 2, 3]])
IDENT = np.float32([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])
LENS = ((0, -4, 2), (0, 0.92, -0.38), (0, 0, 1), 0.8, 0.0, 1.0)


@pytest.fixture(scope="module")
def library():
    return build.build_library()


def _capi_scene(h):
    """test_shim.cpp's calls, through capi; returns (sensor, lens)."""
    mesh = capi.create_mesh(h, memoryview(QUAD.tobytes()), None, None,
                            memoryview(QUAD_IDX.tobytes()))
    white = capi.create_solid_texture3(h, 0.8, 0.8, 0.8)
    black = capi.create_solid_texture3(h, 0, 0, 0)
    rough = capi.create_solid_texture1(h, 1.0)
    metal = capi.create_solid_texture1(h, 0.0)
    mat = capi.create_material(h, -1, black, white, metal, rough, 1.5)
    capi.create_instance(h, memoryview(IDENT.tobytes()),
                         memoryview(np.uint32([mesh, mat, 0]).tobytes()),
                         True)
    sensor = capi.create_sensor(h, 32, 24)
    (ox, oy, oz), (fx, fy, fz), (ux, uy, uz), vfov, ap, fd = LENS
    lens = capi.create_lens(h, ox, oy, oz, fx, fy, fz, ux, uy, uz, vfov, ap,
                            fd)
    return sensor, lens


def test_capi_matches_engine(monkeypatch):
    """The flat functions drive an Engine on the CPU under MSN_PLATFORM=cpu
    to the image the Engine renders for the same scene entered directly,
    bit for bit; the host buffer follows the sensor."""
    monkeypatch.setenv("MSN_PLATFORM", "cpu")
    h = capi.create()
    try:
        assert capi.get_engine(h).device.type == "cpu"
        sensor, lens = _capi_scene(h)
        for _ in range(2):
            assert capi.render(h, sensor, lens)
        assert capi.sample_count(h, sensor) == 2
        ptr = capi.get_sensor_data_ptr(h, sensor)
        got = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)),
            shape=(24, 32, 4)).copy()
    finally:
        capi.destroy(h)
    e = Engine(device="cpu")
    mesh = e.create_mesh(QUAD, QUAD_IDX)
    white = e.create_solid_texture([0.8, 0.8, 0.8])
    black = e.create_solid_texture([0, 0, 0])
    rough = e.create_solid_texture([1.0])
    metal = e.create_solid_texture([0.0])
    mat = e.create_material(color=white, metalness=metal, roughness=rough,
                            emissive=black, ior=1.5)
    e.create_instance(IDENT, [(mesh, mat, False)])
    s = e.create_sensor(32, 24)
    (o, f, u, vfov, ap, fd) = LENS
    ln = e.create_lens(Lens(origin=np.float32(o), forward=np.float32(f),
                            up=np.float32(u), vfov=vfov, aperture=ap,
                            focus_distance=fd))
    e.render(s, ln)
    want = e.render(s, ln)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] < 0.95).any() and np.isfinite(got).all()


def test_create_needs_a_card_or_the_cpu(monkeypatch):
    """Without MSN_PLATFORM=cpu an engine is on `cuda`; with no card,
    creation raises (the shim turns that into a null engine)."""
    import torch

    monkeypatch.delenv("MSN_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert capi.engine_device() == "cuda"
    else:
        with pytest.raises(RuntimeError, match="MSN_PLATFORM=cpu"):
            capi.create()


def test_header_is_the_reference_header():
    assert (build.NATIVE / "moonshine_tpu.h").read_bytes() == \
        HEADER.read_bytes()


def test_library_exports_every_symbol(library):
    """Every function the header declares is exported by the library."""
    names = sorted(set(re.findall(r"\b(Msn[A-Za-z0-9]+)\s*\(",
                                  HEADER.read_text())))
    assert len(names) >= 29
    lib = ctypes.CDLL(str(library))
    missing = [n for n in names if not hasattr(lib, n)]
    assert not missing, missing


def _run(exe, cwd, *args):
    return subprocess.run([str(exe), *map(str, args)], capture_output=True,
                          text=True, env=build.host_env(cpu=True), cwd=cwd,
                          timeout=240)


def test_cpp_host_end_to_end(library, tmp_path):
    """The port's copy of native/test_shim.cpp built against the library
    and run with MSN_PLATFORM=cpu: scene upload, renders, a visibility
    edit, the EXR round trip; prints "shim ok"."""
    exe = build.build_host([build.NATIVE / "test_shim.cpp"],
                           tmp_path / "test_shim")
    r = _run(exe, tmp_path, tmp_path / "shim.exr")
    assert r.returncode == 0, (r.stdout[-300:], r.stderr[-800:])
    assert "shim ok" in r.stdout
    back = exr.read_exr(tmp_path / "shim.exr")
    assert back.shape == (24, 32, 4) and np.isfinite(back).all()


def test_mock_hydra_session(library, tmp_path):
    """native/hydra/test_hydra_core.cpp and hydra_core.cpp, compiled from
    their place unedited, linked against the port's library: the mock
    Hydra session prints "hydra core ok"."""
    exe = build.build_host([HYDRA / "test_hydra_core.cpp",
                            HYDRA / "hydra_core.cpp"],
                           tmp_path / "test_hydra_core")
    r = _run(exe, tmp_path)
    assert r.returncode == 0, (r.stdout[-300:], r.stderr[-800:])
    assert "hydra core ok" in r.stdout


def _exr_lib(library):
    lib = ctypes.CDLL(str(library))
    fp = ctypes.POINTER(ctypes.c_float)
    u32 = ctypes.c_uint32
    lib.MsnExrWrite.argtypes = [ctypes.c_char_p, fp, u32, u32, u32]
    lib.MsnExrWrite2.argtypes = [ctypes.c_char_p, fp, u32, u32, u32, u32]
    lib.MsnExrRead.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp),
                               ctypes.POINTER(u32), ctypes.POINTER(u32)]
    lib.MsnExrFree.argtypes = [fp]
    return lib


def _write(lib, path, img, compression=None):
    img = np.ascontiguousarray(img, np.float32)
    ptr = img.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    h, w, c = img.shape
    if compression is None:
        return lib.MsnExrWrite(str(path).encode(), ptr, w, h, c)
    return lib.MsnExrWrite2(str(path).encode(), ptr, w, h, c, compression)


def _read(lib, path):
    out = ctypes.POINTER(ctypes.c_float)()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    rc = lib.MsnExrRead(str(path).encode(), ctypes.byref(out),
                        ctypes.byref(w), ctypes.byref(h))
    assert rc == 0, rc
    arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 4)).copy()
    lib.MsnExrFree(out)
    return arr


def test_exr_entry_points_round_trip(library, tmp_path):
    """MsnExrWrite / MsnExrWrite2 (ZIP, PIZ) and MsnExrRead in this
    process through capi and io/exr.py: exact round trips both ways, and
    the C codec's refusal of other compressions."""
    lib = _exr_lib(library)
    rs = np.random.RandomState(4)
    img = (rs.rand(21, 33, 3) * 8).astype(np.float32)
    assert _write(lib, tmp_path / "zip.exr", img) == 0
    np.testing.assert_array_equal(exr.read_exr(tmp_path / "zip.exr")[..., :3],
                                  img)
    rgba = (rs.randn(17, 40, 4) * 10).astype(np.float32)
    assert _write(lib, tmp_path / "piz.exr", rgba, exr.PIZ) == 0
    np.testing.assert_array_equal(_read(lib, tmp_path / "piz.exr"), rgba)
    exr.write_exr(tmp_path / "py.exr", img, compression=exr.RLE)
    back = _read(lib, tmp_path / "py.exr")
    np.testing.assert_array_equal(back[..., :3], img)
    assert (back[..., 3] == 1.0).all()
    assert _write(lib, tmp_path / "bad.exr", img, exr.RLE) == 1
    out = ctypes.POINTER(ctypes.c_float)()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    assert lib.MsnExrRead(str(tmp_path / "missing.exr").encode(),
                          ctypes.byref(out), ctypes.byref(w),
                          ctypes.byref(h)) != 0


def test_capi_imports_no_jax():
    """capi (and with it the engine) imports where jax and the JAX package
    cannot be imported."""
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['moonshine_tpu'] = None\n"
            "import moonshine_tpu_torch.capi, moonshine_tpu_torch.native.build\n"
            "bad = [m for m in sys.modules if sys.modules[m] is not None and "
            "m.split('.')[0] in ('jax', 'jaxlib', 'moonshine_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip() == "ok"
