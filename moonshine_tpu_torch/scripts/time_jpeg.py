"""Host time of the port's JPEG decode (io/jpeg.py) on a 2048x2048
texture, and the baseline encoder that writes it:

    python -m moonshine_tpu_torch.scripts.time_jpeg [--size 2048] [--reps 2]

The file is a seeded 4:2:0 baseline JPEG of random quantised
coefficients (`hand_jpeg`: about eight nonzero AC coefficients a block,
2.3 bits a pixel at 2048x2048), written by the encoder below, since the
card's host has no PIL. Prints one JSON line: the file's bytes
and bits per pixel, each decode's seconds, and their minimum. The decode
runs on the host's CPU whatever the device: no part of it is device
time. tests/test_torch_jpeg.py uses `hand_jpeg` for the sampling
factors and restart intervals PIL does not write.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time

import numpy as np


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _BitWriter:
    """Huffman bits into bytes, 0xFF stuffed with 0x00."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):  # pad with 1s to the byte
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def hand_jpeg(w, h, sampling, seed, restart=0, ids=(1, 2, 3),
              big=False) -> bytes:
    """A baseline JPEG of random quantised coefficients: components with
    the given (h, v) sampling factors, interleaved, DC codes all 4 bits
    and AC codes all 8 bits long (a valid, if poor, Huffman table)."""
    rs = np.random.RandomState(seed)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts = [rs.randint(1, 12, 64), rs.randint(2, 16, 64)]
    coefs = []
    for (ch, cv) in sampling:
        c = np.zeros((mcuy * cv, mcux * ch, 64), np.int64)
        c[..., 0] = rs.randint(-60, 60, c.shape[:2]) * (4 if big else 1)
        for k in range(1, 20):  # zigzag positions
            mask = rs.rand(*c.shape[:2]) < 0.4
            c[..., k] = np.where(mask, rs.randint(-12, 13, c.shape[:2]), 0)
        if big:
            c[..., 1:6] *= 6
        coefs.append(c.tolist())
    dc_syms = list(range(12))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
    dc_code = {s: i for i, s in enumerate(dc_syms)}
    ac_code = {s: i for i, s in enumerate(ac_syms)}

    def cat(v):
        return int(abs(v)).bit_length()

    def bits(v, n):
        return v if v >= 0 else v + (1 << n) - 1

    out = bytearray(b"\xff\xd8")
    for i, q in enumerate(qts):
        out += _segment(0xDB, bytes([i]) + bytes(int(x) for x in q))
    nc = len(sampling)
    sof = struct.pack(">BHHB", 8, h, w, nc)
    for i, (ch, cv) in enumerate(sampling):
        sof += bytes([ids[i], (ch << 4) | cv, 0 if i == 0 else 1])
    out += _segment(0xC0, sof)
    counts = [0] * 16
    counts[3] = len(dc_syms)
    out += _segment(0xC4, bytes([0x00] + counts) + bytes(dc_syms))
    counts = [0] * 16
    counts[7] = len(ac_syms)
    out += _segment(0xC4, bytes([0x10] + counts) + bytes(ac_syms))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[i], 0x00]) for i in range(nc))
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    bw = _BitWriter()
    pred = [0] * nc
    n_mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
                pred = [0] * nc
            for ci, (ch, cv) in enumerate(sampling):
                for v in range(cv):
                    for hh in range(ch):
                        blk = coefs[ci][my * cv + v][mx * ch + hh]
                        diff = blk[0] - pred[ci]
                        pred[ci] = blk[0]
                        s = cat(diff)
                        bw.put(dc_code[s], 4)
                        bw.put(bits(diff, s), s)
                        run = 0
                        last = max([k for k in range(1, 64) if blk[k]],
                                   default=0)
                        for k in range(1, last + 1):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bw.put(ac_code[0xF0], 8)
                                run -= 16
                            s = cat(blk[k])
                            bw.put(ac_code[(run << 4) | s], 8)
                            bw.put(bits(blk[k], s), s)
                            run = 0
                        if last < 63:
                            bw.put(ac_code[0x00], 8)
            n_mcu += 1
    bw.flush()
    return bytes(out + bw.out + b"\xff\xd9")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="time_jpeg")
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    from ..io.jpeg import decode_jpeg

    n = args.size
    data = hand_jpeg(n, n, [(2, 2), (1, 1), (1, 1)], seed=2048)
    seconds = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        img = decode_jpeg(data)
        seconds.append(time.perf_counter() - t0)
    out = {"size": [n, n], "sampling": "4:2:0 baseline", "bytes": len(data),
           "bits_per_pixel": 8 * len(data) / (n * n),
           "decode_s": seconds, "min_s": min(seconds),
           "mean_texel": float(img[..., :3].mean())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
