"""The PyTorch port imports without jax and without the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "moonshine_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py"))


def test_imports_with_jax_unimportable():
    """Every module of the port imports in a process where `import jax`
    fails, and none of it pulls in the JAX package (moonshine_tpu)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import moonshine_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'moonshine_tpu'))]\n"
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
