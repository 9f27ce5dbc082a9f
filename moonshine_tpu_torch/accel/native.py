"""Build and load the CUDA libraries: the traversal kernels
(csrc/traverse.cu, csrc/treelet.cu and csrc/vpacket.cu, which share
csrc/visit.cuh), the arithmetic microbenchmarks (csrc/vpu.cu) and the
quantised-row decode probe (csrc/bitcast.cu).

nvcc compiles each source into a shared library with a plain C
interface, loaded with ctypes. A library is built at first use into
`build/` at the root of the checkout (listed in .gitignore) and rebuilt
whenever its source, the shared header or the flags change: its name
carries their hash. `build_all` starts one nvcc per source at once and
waits for all. Nothing here runs at import time.
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
CSRC = _ROOT / "moonshine_tpu_torch" / "csrc"
SOURCES = {"traverse": CSRC / "traverse.cu", "treelet": CSRC / "treelet.cu",
           "vpacket": CSRC / "vpacket.cu", "vpu": CSRC / "vpu.cu",
           "bitcast": CSRC / "bitcast.cu"}
HEADERS = [CSRC / "visit.cuh"]
BUILD_DIR = _ROOT / "build"
# -fmad=false keeps every multiply and add separately rounded, as in the
# plain torch version; IEEE division is nvcc's default without fast math
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int


class NativeLib:
    """A loaded library plus what its build reported."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(str(path))

    def _fn(self, name: str, argtypes: list):
        fn = getattr(self._lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
        return fn


class TraverseLib(NativeLib):
    """traverse.cu's entry points: after the rays, the launch layout (top
    rows, stack depth) and the ray counter; vpacket.cu's take the rays
    alone, under another prefix."""

    prefix = "msn"
    layout = [_I, _I, _P]

    def __init__(self, *args):
        super().__init__(*args)
        rays = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I] + self.layout
        self.closest_hit = self._fn(f"{self.prefix}_closest_hit",
                                    rays + [_P, _P, _P, _P, _P])
        self.any_hit = self._fn(f"{self.prefix}_any_hit", rays + [_P, _P])
        self.stack_capacity = int(
            self._fn(f"{self.prefix}_stack_capacity", [])())
        if self.layout:
            self.shared_bytes = self._fn("msn_shared_bytes", [_I, _I, _I])
            self.group_lanes = self._fn("msn_group_lanes", [_I])


class VPacketLib(TraverseLib):
    prefix = "msn_v"
    layout = []


class TreeletLib(NativeLib):
    """treelet.cu's entry points: phase 1 (`pending`), the walk (after the
    tree: roots, boxes, K and the treelet stack bound; then the pending
    words, nearest treelets and rays) and the walk's block size."""

    def __init__(self, *args):
        super().__init__(*args)
        self.pending = self._fn("msn_treelet_pending",
                                [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P])
        rays = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                _P, _P, _I]
        self.closest_hit = self._fn("msn_treelet_closest_hit",
                                    rays + [_P, _P, _P, _P, _P])
        self.any_hit = self._fn("msn_treelet_any_hit", rays + [_P, _P])
        self.block = self._fn("msn_treelet_block", [_I])
        self.stack_capacity = int(
            self._fn("msn_treelet_stack_capacity", [])())


class VpuLib(NativeLib):
    def __init__(self, *args):
        super().__init__(*args)
        self.slab = self._fn("msn_vpu_slab",
                             [_P] * 7 + [_I] * 5 + [_P, _P])
        self.alu = self._fn("msn_vpu_alu", [_P, _P, _P, _I, _I, _I, _P])


class BitcastLib(NativeLib):
    def __init__(self, *args):
        super().__init__(*args)
        self.decode = self._fn("msn_bitcast_decode", [_P, _I, _P, _P])


_CLASSES = {"traverse": TraverseLib, "treelet": TreeletLib,
            "vpacket": VPacketLib, "vpu": VpuLib, "bitcast": BitcastLib}
_LOADED: dict[str, NativeLib] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA traversal kernels need the "
                       "CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _target(name: str) -> pathlib.Path:
    blob = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in HEADERS) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(blob).hexdigest()[:16]
    return BUILD_DIR / f"libmsn_{name}_{digest}.so"


def build_all(names=tuple(SOURCES)) -> dict[str, NativeLib]:
    """Build (one nvcc per missing library, all started together) and load
    the named libraries; cached per process."""
    t0 = time.perf_counter()
    started = {}
    for name in names:
        out = _target(name)
        if name in _LOADED or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        started[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (out, tmp, proc) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name].name} "
                          f"({proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see a part
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = _CLASSES[name](_target(name), seconds,
                                           logs.get(name, ""))
    return {name: _LOADED[name] for name in names}


def _lib(name: str) -> NativeLib:
    """A loaded library, built at its first use in this process; later
    calls cost a dict lookup (wrappers call this at every launch)."""
    lib = _LOADED.get(name)
    return lib if lib is not None else build_all((name,))[name]


def traverse_lib() -> TraverseLib:
    """The packet traversal library (csrc/traverse.cu)."""
    return _lib("traverse")


def treelet_lib() -> TreeletLib:
    """The treelet traversal library (csrc/treelet.cu)."""
    return _lib("treelet")


def vpacket_lib() -> VPacketLib:
    """The format-V traversal library (csrc/vpacket.cu)."""
    return _lib("vpacket")


def vpu_lib() -> VpuLib:
    """The arithmetic microbenchmark library (csrc/vpu.cu)."""
    return _lib("vpu")


def bitcast_lib() -> BitcastLib:
    """The quantised-row decode probe's library (csrc/bitcast.cu)."""
    return _lib("bitcast")
