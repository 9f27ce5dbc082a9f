"""Quantised-row decode probe (port of scripts/probe_bitcast.py), and the
wrapper of its CUDA kernel (csrc/bitcast.cu).

    python -m moonshine_tpu_torch.scripts.probe_bitcast

Checks the scalar decode a quantised traversal row needs, at the row
widths such rows take (rowlen 40/56/64/72/80/128): row 1 of an int32
[4, rowlen] array is copied into on-chip memory, then decoded as

  out[0] = f32(row[0]) * 2^-20                  fixed-point box word
  out[1] = 2.5 + f32(row[1] & 0xFFFF) * 0.125   low u16 half
  out[2] = 2.5 + f32((row[1] >> 16) & 0xFFFF) * 0.125   high u16 half
  out[3] = f32(row[rowlen - 1])                 exact pointer / id

each broadcast along its row of a float32 [4, 128] output.

`decode_rows` launches the CUDA kernel for a CUDA tensor and runs the
plain torch version (`decode_rows_plain`) for a CPU tensor; any other
device raises. `run` decodes the reference's rows (-3.25 in fixed point,
the halves 7 and 65535, the id 1234567) and prints PASS or FAIL as the
reference does; `main` runs the six widths, prints `overall: PASS` or
`overall: FAIL`, and returns the exit code (1 on FAIL).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..accel import native

ROWLENS = (40, 56, 64, 72, 80, 128)
OUT_COLS = 128
MAX_ROWLEN = 12288  # 48 KB of dynamic shared memory
FIX_SCALE = 1.0 / (1 << 20)
U16_BASE, U16_STEP = 2.5, 0.125

LAUNCHES = {"bitcast": 0}


def reset_launch_counts() -> None:
    LAUNCHES["bitcast"] = 0


def reference_rows(rowlen: int, device="cuda") -> torch.Tensor:
    """The reference's int32 [4, rowlen] input (probe_bitcast.py:64-69):
    zeros but row 1's fixed-point -3.25, its u16 pair (7, 65535) and its
    last word 1234567."""
    rows = np.zeros((4, rowlen), np.uint32)
    rows[1, 0] = np.int64(round(-3.25 * (1 << 20))).astype(np.uint32)
    rows[1, 1] = np.uint32(7 | (65535 << 16))
    rows[1, rowlen - 1] = 1234567
    return torch.from_numpy(rows.view(np.int32)).to(device)


def seeded_rows(rowlen: int, seed: int, device="cuda") -> torch.Tensor:
    """Uniform random int32 [4, rowlen] words: row[0] and row[rowlen - 1]
    mostly above 2^24 in magnitude, where the float conversion rounds."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(-2**31, 2**31, (4, rowlen), dtype=np.int64)
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def decode_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """The decode in torch ops: float32 [4, 128] on rows' device."""
    row = rows[1]
    q = row[1]
    vals = torch.stack([
        row[0].to(torch.float32) * FIX_SCALE,
        U16_BASE + (q & 0xFFFF).to(torch.float32) * U16_STEP,
        U16_BASE + ((q >> 16) & 0xFFFF).to(torch.float32) * U16_STEP,
        row[-1].to(torch.float32),
    ])
    return vals[:, None].expand(4, OUT_COLS).contiguous()


def decode_rows(rows: torch.Tensor) -> torch.Tensor:
    """The decode: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. rows: contiguous int32 [4, rowlen], 2 <= rowlen <=
    12288. Raises on anything else and on a failed launch."""
    if rows.dtype != torch.int32 or rows.ndim != 2 or rows.shape[0] != 4:
        raise ValueError(f"rows must be int32 [4, rowlen], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    rowlen = rows.shape[1]
    if not 2 <= rowlen <= MAX_ROWLEN:
        raise ValueError(f"rowlen {rowlen} outside 2..{MAX_ROWLEN}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.device.type == "cpu":
        return decode_rows_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    out = torch.empty((4, OUT_COLS), dtype=torch.float32, device=rows.device)
    rc = native.bitcast_lib().decode(
        rows.data_ptr(), rowlen, out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitcast kernel launch failed: cudaError {rc}")
    LAUNCHES["bitcast"] += 1
    return out


def run(rowlen: int, device="cuda") -> bool:
    """Decode the reference's rows at one width; prints and returns PASS."""
    out = decode_rows(reference_rows(rowlen, device)).cpu().numpy()
    got = out[:, 0]
    want = [-3.25, 2.5 + 7 * 0.125, 2.5 + 65535 * 0.125, 1234567.0]
    ok = bool(np.allclose(got, want) and (out == got[:, None]).all())
    print(f"rowlen={rowlen:3d}: {'PASS' if ok else 'FAIL'}  got={got}",
          flush=True)
    return ok


def main(device="cuda") -> int:
    """Runs the six widths; 0 when every one passes, else 1."""
    all_ok = True
    for rowlen in ROWLENS:
        try:
            all_ok &= run(rowlen, device)
        except Exception as e:  # noqa: BLE001 -- reported, the run goes on
            all_ok = False
            print(f"rowlen={rowlen:3d}: ERROR {str(e)[:200]}", flush=True)
    print("overall:", "PASS" if all_ok else "FAIL", flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
