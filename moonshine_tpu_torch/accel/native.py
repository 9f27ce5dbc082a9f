"""Build and load the CUDA traversal library (csrc/traverse.cu).

nvcc compiles the source into a shared library with a plain C interface,
loaded with ctypes. It is built at first use into `build/` at the root
of the checkout (listed in .gitignore) and rebuilt whenever the source or
the flags change: the library's name carries their hash. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "moonshine_tpu_torch" / "csrc" / "traverse.cu"
BUILD_DIR = _ROOT / "build"
# -fmad=false keeps every multiply and add separately rounded, as in the
# plain torch version; IEEE division is nvcc's default without fast math
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int


class TraverseLib:
    """The loaded library plus what its build reported."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        lib = ctypes.CDLL(str(path))
        lib.msn_stack_capacity.argtypes = []
        lib.msn_stack_capacity.restype = _I
        lib.msn_closest_hit.argtypes = (
            [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P])
        lib.msn_closest_hit.restype = _I
        lib.msn_any_hit.argtypes = (
            [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P])
        lib.msn_any_hit.restype = _I
        self.closest_hit = lib.msn_closest_hit
        self.any_hit = lib.msn_any_hit
        self.stack_capacity = int(lib.msn_stack_capacity())
        self._lib = lib


_LOADED: TraverseLib | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA traversal kernels need the "
                       "CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def traverse_lib() -> TraverseLib:
    """Build (if needed) and load the library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmsn_traverse_{digest}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a part
    _LOADED = TraverseLib(out, time.perf_counter() - t0, log)
    return _LOADED
