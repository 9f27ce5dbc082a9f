"""Lane sorting (port of moonshine_tpu/core/sortutil.py): one stable sort
of a lane batch by a small int32 key that moves every lane array along.

`sort_lanes` returns the permutation (int32: the stable order of the
keys, `torch.argsort(key, stable=True)`) and each array in that order;
`unsort_lanes` puts arrays back into lane order by a permutation (a
scatter: the reference's second sort by the lane iota). For CUDA tensors
both launch the kernels of csrc/sort.cu on the tensors' card and its
current stream (so a CUDA graph captures them): a stable LSD radix sort
over the few digits the key's range needs (one memset, one launch that
counts every pass's digits, making the keys first where their inputs are
given, then one launch a pass: one pass for the
packet key, two for the resort's and the treelet dispatch's), then one
launch that moves every array, one array after another. For CPU tensors
they run their plain versions (`*_plain`: an argsort and a gather or
`index_copy_` per array). There is no fallback: a kernel that does not
build or launch raises. Each wrapper adds one to LAUNCHES[its name]
where it launches (into a capture's tally while a graph is captured:
accel/launch.py).

The key is an int32 tensor or, as every site gives it, the key's inputs
(`KeyIn`: a lane's origin cell in the scene's box and its direction's
octant, `coherence_key_plain`'s arguments). Given its inputs, the card's
first sort kernel makes each lane's key itself, so no key is written and
read back by a launch of its own; the plain version makes it with
`coherence_key_plain` first. The key's range is the caller's to state:
`bits` says every key lies in [0, 2^bits) or is a dead lane's key, 1 <<
20 at every site. Any key past the range, a negative one too, sorts as
one value after it (`mapped_key`), on the card and in the plain version,
so where the dead key is the only such value the order is the stable
argsort of the key itself. The sites and their keys: the per-bounce
state resort (integrator/path.py: 8^3 cells), the traversal dispatch's
coherence sort (accel/packet.py: 4^3 cells) and the treelet dispatch's
(accel/treelet.py: 4^3 cells after the nearest treelet).

Arrays are [N] or [N, K] tensors of any dtype (bool, int32, int64,
float32 at the sites). `rows` (one int an array, default its length)
lets a caller write only part of an output: out[j][i] = arrays[j][perm[i]]
for i below min(rows[j], N), and arrays[j][i] itself for N <= i <
rows[j] (an array may be longer than the key: its lanes past the key's
are not sorted). `out` gives the output tensors (the integrator's static
buffers); they must not overlap the inputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..accel import native
from ..accel.launch import Counts, call_on, count_launch

# Kernel launches per wrapper (see the module docstring)
LAUNCHES = Counts({"sort_lanes": 0, "unsort_lanes": 0})
DEAD_KEY = 1 << 20  # the sites' key of a dead lane
_MAX_BITS = 30


class KeyIn(NamedTuple):
    """The inputs of the lanes' coherence key (`coherence_key_plain`):
    each lane's origin cell among `cells`^3 of the box `bounds` ([2, 3]:
    lower and upper corner), clamped into it, times 8 direction octants
    (x, y, z positive: 4, 2, 1), in [0, 2^key_bits(cells)); plus major x
    cells^3 x 8 where `major` (int32 [N]) is given; DEAD_KEY where
    `active` (bool [N]) is False. o and d float32 [N, 3]."""

    o: torch.Tensor
    d: torch.Tensor
    bounds: torch.Tensor
    cells: int
    active: torch.Tensor | None = None
    major: torch.Tensor | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows(arrays, rows, n: int) -> list:
    rows = [a.shape[0] for a in arrays] if rows is None else list(rows)
    if len(rows) != len(arrays):
        raise ValueError("rows needs one count an array")
    for a, r in zip(arrays, rows):
        if a.shape[0] < n or not 0 <= r <= a.shape[0]:
            raise ValueError(f"an array of {a.shape[0]} lanes for {n} keys "
                             f"and {r} rows")
    return rows


def _check_key_in(k: KeyIn) -> None:
    n, dev = k.o.shape[0], k.o.device
    for name, x, dtype, shape in (("o", k.o, torch.float32, (n, 3)),
                                  ("d", k.d, torch.float32, (n, 3)),
                                  ("bounds", k.bounds, torch.float32, (2, 3)),
                                  ("active", k.active, torch.bool, (n,)),
                                  ("major", k.major, torch.int32, (n,))):
        if x is not None and (x.dtype != dtype or tuple(x.shape) != shape
                              or x.device != dev):
            raise ValueError(f"{name} must be {dtype} {list(shape)} on the "
                             f"rays' device")
    if k.cells < 1:
        raise ValueError(f"cells must be positive, got {k.cells}")


def _lanes_of(key):
    """(lanes, device) of a key tensor or KeyIn."""
    x = key.o if isinstance(key, KeyIn) else key
    return x.shape[0], x.device


def _check(key, arrays, bits: int, out):
    if isinstance(key, KeyIn):
        _check_key_in(key)
    elif key.ndim != 1:
        raise ValueError(f"the key must be [N], got {tuple(key.shape)}")
    if not 0 <= bits <= _MAX_BITS:
        raise ValueError(f"bits must lie in [0, {_MAX_BITS}], got {bits}")
    device = _lanes_of(key)[1]
    for a in arrays:
        if a.device != device or a.ndim not in (1, 2):
            raise ValueError("each array must be [N] or [N, K] on the key's "
                             "device")
    if out is not None:
        if len(out) != len(arrays):
            raise ValueError("out needs one tensor an array")
        for a, o in zip(arrays, out):
            if (o.dtype != a.dtype or o.shape[1:] != a.shape[1:]
                    or o.device != a.device):
                raise ValueError("each out tensor must match its array's "
                                 "dtype, row shape and device")


def _device_kind(x) -> str:
    """"cpu" or "cuda": the kind of x's device (x a tensor or a device)."""
    device = x if isinstance(x, torch.device) else x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lane sort for device {device}")
    return device.type


def key_bits(cells: int) -> int:
    """Bits of a coherence key of `cells`^3 origin cells x 8 octants (a
    power of two)."""
    return (cells ** 3 * 8 - 1).bit_length()


# --- plain torch versions ---

def coherence_key_plain(o, d, bounds, cells: int, active=None, major=None):
    """The coherence key (int32 [N]) of `KeyIn`'s inputs in torch ops: the
    reference of the key that the card's sort makes. A cell coordinate
    past the int32 range (a flat box's axis, an origin far outside it)
    saturates and NaN goes to 0 before the cast, as the reference's cast
    and the card's do (x86's gives INT_MIN)."""
    lo = bounds[0]
    inv_ext = 1.0 / torch.clamp_min(bounds[1] - lo, 1e-20)
    x = (o - lo) * inv_ext * float(cells)
    cell = torch.nan_to_num(x, nan=0.0).clamp(0, cells - 1).to(torch.int32)
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    key = ((cell[:, 0] * cells + cell[:, 1]) * cells + cell[:, 2]) * 8 \
        + octant
    if major is not None:
        key = major * (cells ** 3 * 8) + key
    if active is not None:
        key = torch.where(active, key, DEAD_KEY)
    return key


def mapped_key(key, bits: int):
    """The key as the sort orders it: itself in [0, 2^bits), 2^bits for
    any other key (a dead lane's, a negative one)."""
    live = 1 << bits
    return torch.where((key >= 0) & (key < live), key, live)


def key_tensor(key):
    """The int32 key [N] itself, or coherence_key_plain of a KeyIn."""
    return coherence_key_plain(*key) if isinstance(key, KeyIn) else key


def sort_lanes_plain(key, arrays, bits: int, out=None, rows=None):
    """sort_lanes in torch ops (the kernels' reference): the key made by
    coherence_key_plain where its inputs are given, the stable argsort of
    the mapped key and a gather per array."""
    _check(key, arrays, bits, out)
    key = key_tensor(key)
    n = key.shape[0]
    rows = _rows(arrays, rows, n)
    perm = torch.argsort(mapped_key(key, bits), stable=True)
    result = []
    for j, (a, r) in enumerate(zip(arrays, rows)):
        moved = a[perm[:min(r, n)]]
        if r > n:
            moved = torch.cat([moved, a[n:r]])
        if out is not None:
            out[j][:r].copy_(moved)
            moved = out[j]
        result.append(moved)
    return perm.to(torch.int32), result


def unsort_lanes_plain(perm, arrays):
    """unsort_lanes in torch ops: an index_copy_ per array."""
    index = perm.to(torch.int64)
    return [torch.empty_like(a).index_copy_(0, index, a) for a in arrays]


# --- CUDA wrappers ---

def _word(row_bytes: int, *ptrs) -> int:
    """The widest word (16, 8, 4, 2 or 1 bytes) that divides a row and
    every pointer."""
    for w in (16, 8, 4, 2, 1):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def _move(lib, perm, n: int, srcs, dsts, rows_perm, rows_total,
          scatter: bool) -> None:
    """One launch of the move kernel over these columns."""
    cols = len(srcs)
    if cols > lib.max_cols:
        raise ValueError(f"a move takes at most {lib.max_cols} arrays")
    word, words = [], []
    for s, d in zip(srcs, dsts):
        row = (s.shape[1] if s.ndim == 2 else 1) * s.element_size()
        w = _word(row, s.data_ptr(), d.data_ptr())
        word.append(w)
        words.append(row // w)
    if max(rows_total, default=0) >= 2**31:
        raise ValueError("too many lanes for one launch")
    arr = lambda kind, xs: (kind * max(cols, 1))(*xs)
    rc = call_on(
        lib.move, perm.device,
        arr(ctypes.c_longlong, [s.data_ptr() for s in srcs]),
        arr(ctypes.c_longlong, [d.data_ptr() for d in dsts]),
        arr(ctypes.c_int, word), arr(ctypes.c_int, words),
        arr(ctypes.c_int, rows_perm), arr(ctypes.c_int, rows_total), cols,
        perm.data_ptr(), n, int(scatter))
    if rc != 0:
        raise RuntimeError(f"lane move kernel launch failed: cudaError {rc}")


def _overlaps(a, b) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _contiguous_out(out, arrays, rows):
    for o, r in zip(out, rows):
        if not o.is_contiguous() or o.shape[0] < r:
            raise ValueError("out tensors must be contiguous, each with "
                             "its array's rows")
        if any(_overlaps(o, x) for x in arrays):
            raise ValueError("an out tensor overlaps an input array")


def _permutation(lib, key, n: int, bits: int):
    """perm int32 [n]: one launch of lib's permutation kernels on a key
    tensor or, through its first kernel, a KeyIn's lanes."""
    dev = key.o.device if isinstance(key, KeyIn) else key.device
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    work = torch.empty(lib.work_ints(n, bits), dtype=torch.int32,
                       device=dev)
    if isinstance(key, KeyIn):
        keep = [None if x is None else x.contiguous()
                for x in (key.o, key.d, key.active, key.major, key.bounds)]
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = call_on(lib.sort_keyed, dev, *map(ptr, keep), key.cells,
                     DEAD_KEY, n, bits, work.data_ptr(), perm.data_ptr())
    else:
        if key.dtype != torch.int32:
            raise TypeError(f"the sort kernel takes int32 keys, got "
                            f"{key.dtype}")
        key = key.contiguous()
        rc = call_on(lib.sort, dev, key.data_ptr(), n, bits,
                     work.data_ptr(), perm.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    return perm


def sort_lanes(key, arrays, bits: int, out=None, rows=None):
    """(perm int32 [N], the arrays in perm's order): the stable order of
    the int32 key [N], or of the coherence keys of a KeyIn's lanes,
    mapped by `mapped_key` (module docstring; `out` and `rows` too). The
    csrc/sort.cu kernels for CUDA tensors (given a KeyIn, the first one
    makes the keys), sort_lanes_plain for CPU tensors."""
    n, dev = _lanes_of(key)
    if _device_kind(dev) == "cpu":
        return sort_lanes_plain(key, arrays, bits, out, rows)
    _check(key, arrays, bits, out)
    if n >= 2**31:
        raise ValueError("too many lanes for one sort")
    rows = _rows(arrays, rows, n)
    arrays = [a.contiguous() for a in arrays]
    if out is None:
        out = [torch.empty((r, *a.shape[1:]), dtype=a.dtype, device=dev)
               for a, r in zip(arrays, rows)]
    else:
        _contiguous_out(out, arrays, rows)
    lib = native.sort_lib()
    if n:
        perm = _permutation(lib, key, n, bits)
    else:
        perm = torch.empty(0, dtype=torch.int32, device=dev)
    if arrays:
        _move(lib, perm, n, arrays, out, [min(r, n) for r in rows], rows,
              scatter=False)
    if n or any(rows):
        count_launch(LAUNCHES, "sort_lanes")
    return perm, list(out)


def unsort_lanes(perm, arrays):
    """The arrays ([N] or [N, K], N = perm's length) back in lane order:
    out[j][perm[i]] = arrays[j][i]. The csrc/sort.cu move kernel (one
    launch for every array) for CUDA tensors, unsort_lanes_plain for CPU
    tensors."""
    if _device_kind(perm) == "cpu":
        return unsort_lanes_plain(perm, arrays)
    n, dev = perm.shape[0], perm.device
    if perm.dtype != torch.int32 or perm.ndim != 1:
        raise TypeError("the move kernel takes an int32 [N] permutation")
    for a in arrays:
        if a.shape[0] != n or a.device != dev or a.ndim not in (1, 2):
            raise ValueError("each array must be [N] or [N, K] on the "
                             "permutation's device")
    arrays = [a.contiguous() for a in arrays]
    out = [torch.empty_like(a) for a in arrays]
    if n and arrays:
        _move(native.sort_lib(), perm.contiguous(), n, arrays, out,
              [n] * len(arrays), [n] * len(arrays), scatter=True)
        count_launch(LAUNCHES, "unsort_lanes")
    return out
