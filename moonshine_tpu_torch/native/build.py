"""Build the port's C ABI library and C++ hosts against it.

`build_library()` compiles engine_shim.cpp with g++ into
build/libmoonshine_tpu_torch.so at the root of the checkout (listed in
.gitignore), with the running Python's headers and embedding flags
(`python3-config --includes` and `--ldflags --embed`), at first use and
again whenever the shim, the header, the flags or the Python change: a
digest of them sits beside the library. A host links it as

    g++ -std=c++17 host.cpp -I moonshine_tpu_torch/native -L build \\
        -lmoonshine_tpu_torch -Wl,-rpath,build

(`build_host` does that) and runs with the checkout on PYTHONPATH; with
MSN_PLATFORM=cpu its engines run on the CPU. Nothing here runs at import
time.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shlex
import shutil
import subprocess
import sys
import sysconfig

NATIVE = pathlib.Path(__file__).resolve().parent
ROOT = NATIVE.parents[1]
BUILD_DIR = ROOT / "build"
LIBRARY = BUILD_DIR / "libmoonshine_tpu_torch.so"
SOURCES = [NATIVE / "engine_shim.cpp", NATIVE / "moonshine_tpu.h"]
CXX_FLAGS = ["-O2", "-fPIC", "-Wall", "-std=c++17"]


def _python_config(*args) -> list:
    """python3-config's words for the running interpreter (the one beside
    sys.executable when there is one)."""
    exe = pathlib.Path(sys.executable).with_name(
        f"python{sys.version_info.major}.{sys.version_info.minor}-config")
    tool = str(exe) if exe.exists() else shutil.which("python3-config")
    if tool is None:
        raise RuntimeError("python3-config not found: the C ABI library "
                           "needs Python's development files")
    out = subprocess.run([tool, *args], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tool} {' '.join(args)} failed: {out.stderr}")
    return shlex.split(out.stdout)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the C ABI library needs a C++ "
                           "compiler")
    return cxx


def python_headers() -> pathlib.Path | None:
    """Python.h of the running interpreter, or None when absent."""
    h = pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"
    return h if h.exists() else None


def build_library(force: bool = False) -> pathlib.Path:
    """build/libmoonshine_tpu_torch.so, compiled unless its digest is
    current; returns its path."""
    if python_headers() is None:
        raise RuntimeError("Python.h not found: the C ABI library needs "
                           "Python's development headers")
    includes = _python_config("--includes")
    ldflags = _python_config("--ldflags", "--embed")
    cmd_flags = CXX_FLAGS + includes + ldflags
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in SOURCES)
        + " ".join(cmd_flags).encode() + sys.version.encode()).hexdigest()
    stamp = LIBRARY.with_name(LIBRARY.name + ".digest")
    if (not force and LIBRARY.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, *includes, "-shared",
           str(NATIVE / "engine_shim.cpp"), "-o", str(tmp), *ldflags]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {LIBRARY.name} failed:\n"
                           f"{' '.join(cmd)}\n{out.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader never sees a part
    stamp.write_text(digest)
    return LIBRARY


def build_host(sources, out, include_dirs=()) -> pathlib.Path:
    """Compile C++ `sources` into the executable `out`, linked against the
    library (built first if needed), with this directory's header on the
    include path; returns `out`."""
    lib = build_library()
    out = pathlib.Path(out)
    cmd = [_compiler(), "-O2", "-std=c++17", *map(str, sources),
           f"-I{NATIVE}", *(f"-I{d}" for d in include_dirs), "-o", str(out),
           f"-L{lib.parent}", "-lmoonshine_tpu_torch",
           f"-Wl,-rpath,{lib.parent}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {out.name} failed:\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    return out


def host_env(cpu: bool = False) -> dict:
    """The environment a host runs in: the checkout on PYTHONPATH, and
    MSN_PLATFORM=cpu when `cpu`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if cpu:
        env["MSN_PLATFORM"] = "cpu"
    return env
