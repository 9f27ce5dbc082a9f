"""Build and load the CUDA libraries: the traversal kernels
(csrc/traverse.cu, csrc/treelet.cu, csrc/vpacket.cu and the two-level
walk of csrc/tlas.cu, which share csrc/visit.cuh; traverse.cu and
vpacket.cu also share the group walk of csrc/group_walk.cuh), the
arithmetic microbenchmarks (csrc/vpu.cu), the quantised-row decode
probe (csrc/bitcast.cu), the bounce's shading (csrc/shade.cu), the
lane sort (csrc/sort.cu), the graphs' conditional nodes
(csrc/graph_cond.cu) and a sample's camera rays and accumulation
(csrc/frame.cu);
csrc/tlas.cu is built twice, the second time with its visit counters
(`tlas_count`).

nvcc compiles each source into a shared library with a plain C
interface, loaded with ctypes. A library is built at first use into
`build/` at the root of the checkout (listed in .gitignore) and rebuilt
whenever its source, the shared header or the flags change: its name
carries their hash. `build_all` starts one nvcc per source at once and
waits for all; `build_against` builds another checkout's sources beside
them, for the scripts that time two designs in one process. A library
binds the entry points its source has, so an earlier source loads too.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = _ROOT / "moonshine_tpu_torch" / "csrc"
SOURCES = {"traverse": CSRC / "traverse.cu", "treelet": CSRC / "treelet.cu",
           "vpacket": CSRC / "vpacket.cu", "vpu": CSRC / "vpu.cu",
           "bitcast": CSRC / "bitcast.cu", "tlas": CSRC / "tlas.cu",
           "tlas_count": CSRC / "tlas.cu", "shade": CSRC / "shade.cu",
           "sort": CSRC / "sort.cu", "graph_cond": CSRC / "graph_cond.cu",
           "frame": CSRC / "frame.cu"}
# a library's own flags: tlas_count is the two-level walk that counts its
# visits (accel/tlas.py walk_visits), never the timed build
EXTRA_FLAGS = {"tlas_count": ["-DMSN_TLAS_COUNT"]}
HEADERS = [CSRC / "visit.cuh", CSRC / "group_walk.cuh"]
BUILD_DIR = _ROOT / "build"
# -fmad=false keeps every multiply and add separately rounded, as in the
# plain torch version; IEEE division is nvcc's default without fast math
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


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

    def _has(self, name: str) -> bool:
        return hasattr(self._lib, name)


class TraverseLib(NativeLib):
    """traverse.cu's entry points (vpacket.cu's, over tiles, under the
    prefix msn_v): after the rays, the launch layout (top records, stack
    depth) and the ray counter; `layout` is empty for a source whose entry
    points take the rays alone (the one-thread-per-ray kernels)."""

    prefix = "msn"

    def __init__(self, *args):
        super().__init__(*args)
        self.layout = ([_I, _I, _P]
                       if self._has(f"{self.prefix}_shared_bytes") else [])
        rays = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I] + self.layout
        self.closest_hit = self._fn(f"{self.prefix}_closest_hit",
                                    rays + [_P, _P, _P, _P, _P])
        self.any_hit = self._fn(f"{self.prefix}_any_hit", rays + [_P, _P])
        self.stack_capacity = int(
            self._fn(f"{self.prefix}_stack_capacity", [])())
        if self.layout:
            self.shared_bytes = self._fn(f"{self.prefix}_shared_bytes",
                                         [_I, _I, _I])
            self.group_lanes = self._fn(f"{self.prefix}_group_lanes", [_I])


class VPacketLib(TraverseLib):
    prefix = "msn_v"


class TreeletLib(NativeLib):
    """treelet.cu's entry points: phase 1 (`pending`), the walk (after the
    tree: roots, boxes, K and the treelet stack bound; then the pending
    words, nearest treelets and rays) and the walk's block size. A source
    without phase 1 (`pending` None) has the one-thread-per-ray walk,
    which takes the roots and K alone, and no block size."""

    def __init__(self, *args):
        super().__init__(*args)
        self.pending = self.block = None
        if self._has("msn_treelet_pending"):
            self.pending = self._fn("msn_treelet_pending",
                                    [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P])
            self.block = self._fn("msn_treelet_block", [_I])
            rays = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P,
                    _P, _P, _P, _I]
        else:
            rays = [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
                    _I]
        self.closest_hit = self._fn("msn_treelet_closest_hit",
                                    rays + [_P, _P, _P, _P, _P])
        self.any_hit = self._fn("msn_treelet_any_hit", rays + [_P, _P])
        self.stack_capacity = int(
            self._fn("msn_treelet_stack_capacity", [])())


class VpuLib(NativeLib):
    """vpu.cu's entry points: the two kernels, and the latency probe and an
    empty kernel (None in a source that has only the kernels)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.slab = self._fn("msn_vpu_slab",
                             [_P] * 7 + [_I] * 5 + [_P, _P])
        self.alu = self._fn("msn_vpu_alu", [_P, _P, _P, _I, _I, _I, _P])
        self.latency = self.empty = None
        if self._has("msn_vpu_latency"):
            self.latency = self._fn("msn_vpu_latency",
                                    [_I, _I, _P, _P, _P, _I, _P])
            self.empty = self._fn("msn_vpu_empty", [_P])


class BitcastLib(NativeLib):
    def __init__(self, *args):
        super().__init__(*args)
        self.decode = self._fn("msn_bitcast_decode", [_P, _I, _P, _P])


class TlasLib(NativeLib):
    """tlas.cu's entry points: the walk's records (five pointers, the
    instance and triangle counts, the counters), the rays, the stack
    depth and the ray counter, then the outputs; `counting` is 1 for the
    counting build. `records` is False for a source whose entry points
    take the reference's 15 TLAS arrays and the rays alone (the
    one-thread-per-ray kernel)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.records = self._has("msn_tlas_shared_bytes")
        if self.records:
            rays = ([_P] * 5 + [_I, _I, _P] + [_P, _P, _P, _P, _I]
                    + [_I, _P])
            self.shared_bytes = self._fn("msn_tlas_shared_bytes", [_I])
            self.counting = int(self._fn("msn_tlas_counting", [])())
        else:
            rays = [_P] * 15 + [_I, _I] + [_P, _P, _P, _P, _I]
            self.counting = 0
        self.closest_hit = self._fn("msn_tlas_closest_hit",
                                    rays + [_P, _P, _P, _P, _P, _P])
        self.any_hit = self._fn("msn_tlas_any_hit", rays + [_P, _P])


class ShadeLib(NativeLib):
    """shade.cu's entry points: the surface (with the light draw of a
    bounce or of the direct integrator; it counts the shadow rays it sets
    into a device scalar), scatter (it counts the lanes it leaves live)
    and env miss kernels, and the scatter kernel's weight-only form
    (integrator/shade.py)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.surface = self._fn(
            "msn_shade_surface",
            [_I, _I, _P, _L, _P, _P, _L, _P, _L, _L, _P, _L, _L, _I, _I, _I,
             _I, _F] + [_P] * 12 + [_L] + [_P] * 11
            + [_I, _L, _I, _P, _P, _P, _P, _I, _F, _P, _L, _P, _P, _I,
               _I] + [_P] * 9)
        self.scatter = self._fn(
            "msn_shade_scatter", [_P] * 17 + [_I, _I, _L] + [_P] * 10)
        self.env_miss = self._fn(
            "msn_shade_env_miss", [_P, _I, _F, _I] + [_P] * 6 + [_L, _P, _P,
                                                               _P])
        self.weigh = self._fn(
            "msn_shade_weigh", [_P] * 15 + [_I, _I, _L, _P, _P])


class SortLib(NativeLib):
    """sort.cu's entry points: the permutation of a key (`sort`) or of the
    lanes' coherence keys made from their inputs in its first kernel
    (`sort_keyed`, which leaves the keys at `key_at` in its workspace;
    None in a source before that design), with the int32 words of
    workspace either takes (`work_ints`) in `passes` digit passes; the
    move of lane arrays by a permutation (`move`, at most `max_cols`
    arrays a launch)."""

    def __init__(self, *args):
        super().__init__(*args)
        ints = ctypes.POINTER(_I)
        longs = ctypes.POINTER(_L)
        self.sort = self._fn("msn_sort_lanes", [_P, _I, _I, _P, _P, _P])
        self.sort_keyed = self.key_at = None
        if self._has("msn_sort_keyed"):
            self.sort_keyed = self._fn("msn_sort_keyed",
                                       [_P] * 5 + [_I, _I, _I, _I, _P, _P,
                                                   _P])
            key_at = self._lib.msn_sort_key_at
            key_at.argtypes, key_at.restype = [_I, _I], _L
            self.key_at = key_at
        self.move = self._fn("msn_move_lanes",
                             [longs, longs, ints, ints, ints, ints, _I, _P,
                              _I, _I, _P])
        work = self._lib.msn_sort_work_ints
        work.argtypes, work.restype = [_I, _I], _L
        self.work_ints = work
        self.passes = self._fn("msn_sort_passes", [_I])
        self.max_cols = int(self._fn("msn_sort_max_cols", [])())


class GraphCondLib(NativeLib):
    """graph_cond.cu's entry points: a conditional node (IF or SWITCH)
    with its set kernel begun on a capturing stream (`cond_begin`), a
    handle reset to 0 at each launch (`guard`) and an IF node on it
    (`if_on`), the segment's tail that counts it and sets the next guard
    (`tail`), a body's capture begun and ended on a child stream
    (`body_begin`, `body_end`), a child stream made (`stream`), the
    runtime's and driver's versions and an error's text."""

    def __init__(self, *args):
        super().__init__(*args)
        self.cond_begin = self._fn("msn_cond_begin",
                                   [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P,
                                    _I, _P, _P])
        self.guard = self._fn("msn_guard", [_P, _P])
        self.if_on = self._fn("msn_if_on", [_P, ctypes.c_ulonglong, _P])
        self.tail = self._fn("msn_tail", [_P, _P, ctypes.c_ulonglong, _I,
                                          _P, _I, _I, _L, _P, _I, _I, _L,
                                          _P])
        self.body_begin = self._fn("msn_body_begin", [_P, _P])
        self.body_end = self._fn("msn_body_end", [_P])
        self.stream = self._fn("msn_cond_stream", [ctypes.POINTER(_P)])
        self.versions = self._fn("msn_cond_versions",
                                 [ctypes.POINTER(_I), ctypes.POINTER(_I)])
        error = self._lib.msn_cond_error
        error.argtypes, error.restype = [_I], ctypes.c_char_p
        self.error = lambda err: error(err).decode()


class FrameLib(NativeLib):
    """frame.cu's entry points: the camera rays with the fresh lane
    state (`raygen`) and the sample's accumulation (`accumulate`)
    (render/frame_kernels.py)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.raygen = self._fn("msn_frame_raygen",
                               [_P] * 7 + [_I] * 6 + [_F] + [_P] * 14)
        self.accumulate = self._fn("msn_frame_accumulate",
                                   [_P, _P, _I, _I, _I] + [_P] * 8)


_CLASSES = {"traverse": TraverseLib, "treelet": TreeletLib,
            "vpacket": VPacketLib, "vpu": VpuLib, "bitcast": BitcastLib,
            "tlas": TlasLib, "tlas_count": TlasLib, "shade": ShadeLib,
            "sort": SortLib, "graph_cond": GraphCondLib, "frame": FrameLib}
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


def _flags(name: str) -> list:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> pathlib.Path:
    blob = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in HEADERS) + " ".join(_flags(name)).encode()
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
            [_nvcc(), *_flags(name), "-o", str(tmp), str(SOURCES[name])],
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


def _sources(csrc: pathlib.Path, name: str) -> list:
    """The bytes of library NAME's source and of the headers beside it."""
    return [(f.name, f.read_bytes())
            for f in [csrc / SOURCES[name].name,
                      *sorted(csrc.glob("*.cuh"))]]


def build_against(checkouts, names):
    """Start nvcc on csrc/NAME.cu of each checkout DIR, for each NAME in
    `names`, unless it and the headers beside it equal this checkout's
    (all at once, into build/compare/); returns a function that builds
    this checkout's own meanwhile, waits for all and loads theirs as
    {name: {label: lib}}, a DIR's label being its directory's name."""
    t0 = time.perf_counter()
    started = []
    for i, checkout in enumerate(checkouts):
        csrc = pathlib.Path(checkout) / "moonshine_tpu_torch" / "csrc"
        label = pathlib.Path(checkout).resolve().name
        for name in names:
            if _sources(csrc, name) == _sources(CSRC, name):
                print(f"{checkout}: {name}.cu and its headers equal this "
                      f"checkout's; not built", flush=True)
                continue
            src = csrc / SOURCES[name].name
            out = BUILD_DIR / "compare" / f"libmsn_{name}_{i}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            started.append((name, label, src, out, subprocess.Popen(
                [_nvcc(), *_flags(name), "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def load() -> dict:
        build_all(names)
        libs = {name: {} for name in names}
        for name, label, src, out, proc in started:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            libs[name][label] = _CLASSES[name](out, time.perf_counter() - t0,
                                               log)
        return libs

    return load


def ptxas_summary(log: str) -> str:
    """What ptxas -v said of a build's kernels, in one line: their count,
    the fewest and most registers a thread, and the spill bytes."""
    regs = [int(w.split()[1]) for w in re.findall(r"Used \d+ registers", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
    if not regs:
        return "no ptxas report (built earlier)"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores")


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


def tlas_lib() -> TlasLib:
    """The two-level traversal library (csrc/tlas.cu)."""
    return _lib("tlas")


def tlas_count_lib() -> TlasLib:
    """csrc/tlas.cu built to count its visits (-DMSN_TLAS_COUNT)."""
    return _lib("tlas_count")


def shade_lib() -> ShadeLib:
    """The bounce's shading kernels (csrc/shade.cu)."""
    return _lib("shade")


def sort_lib() -> SortLib:
    """The lane sort and move kernels (csrc/sort.cu)."""
    return _lib("sort")


def graph_cond_lib() -> GraphCondLib:
    """The graphs' conditional nodes (csrc/graph_cond.cu)."""
    return _lib("graph_cond")


def frame_lib() -> FrameLib:
    """A sample's camera rays and accumulation (csrc/frame.cu)."""
    return _lib("frame")
