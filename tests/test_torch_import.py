"""The PyTorch port imports without jax, without the JAX package and
without PIL (none of which the GPU host has)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "moonshine_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py"))
# modules a later slice added, which the walk below must reach
SLICE_MODULES = ["scripts/probe_bitcast.py", "io/exr.py", "io/png.py",
                 "scene/gltf.py", "render/offline.py", "accel/lbvh.py",
                 "accel/wide.py", "scene/world.py", "io/jpeg.py",
                 "io/dds.py", "integrator/direct.py", "parallel/__init__.py",
                 "parallel/sharding.py", "engine/__init__.py",
                 "engine/engine.py", "render/viewer.py",
                 "scripts/time_jpeg.py", "scripts/time_sharded.py",
                 "scripts/compare_shade.py"]
BLOCKED = "sys.modules['jax'] = None\nsys.modules['PIL'] = None\n"


def test_imports_with_jax_unimportable():
    """Every module of the port imports in a process where `import jax`
    and `import PIL` fail, and none of it pulls in the JAX package
    (moonshine_tpu)."""
    code = (
        "import sys, pkgutil, importlib\n" + BLOCKED +
        "import moonshine_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'moonshine_tpu',\n"
        "                            'PIL'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES)
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", text, re.M), path
    assert not re.search(r"^\s*(import|from)\s+moonshine_tpu(\.|\s|$)", text,
                         re.M), path


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_covered(module):
    assert f"moonshine_tpu_torch/{module}" in SOURCES


@pytest.mark.parametrize("entry", [
    "moonshine_tpu_torch.render.offline",
    "moonshine_tpu_torch.scripts.probe_bitcast"])
def test_entry_points_start_without_jax(entry):
    """`python -m <entry> --help` (the CLI) or the module's import (the
    probe, which takes no options) in a process without jax or PIL."""
    argv = ["--help"] if entry.endswith("offline") else []
    run = "runpy.run_module" if argv else "importlib.import_module"
    code = ("import sys, runpy, importlib\n" + BLOCKED
            + f"sys.argv = ['x'] + {argv!r}\n{run}({entry!r}"
            + (", run_name='__main__')\n" if argv else ")\n"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if argv:
        assert out.returncode == 0 and "--max-bounces" in out.stdout, \
            out.stderr
    else:
        assert out.returncode == 0, out.stderr
