"""Host time of the port's JPEG decode (io/jpeg.py) on a 2048x2048
texture, and the encoders that write it:

    python -m moonshine_tpu_torch.scripts.time_jpeg [--size 2048] [--reps 2]

The texture is a seeded 4:2:0 image of random quantised coefficients
(`random_coefs`: about eight nonzero AC coefficients a block), written
twice by the encoders below, since the card's host has no PIL: as a
baseline Huffman JPEG (`hand_jpeg`, 2.3 bits a pixel at 2048x2048) and
as a sequential arithmetic-coded one (`arith_jpeg`, T.81 Annex D as
libjpeg's jcarith.c codes it). Prints one JSON line: for each coding the
file's bytes and bits per pixel, each decode's seconds and their
minimum; both decode to the same texels. The decode runs on the host's
CPU whatever the device: no part of it is device time.
tests/test_torch_jpeg.py uses the encoders for the kinds PIL does not
write (sampling factors, restart intervals, 4-component and
arithmetic-coded files, and progressive scripts that stop short).
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time

import numpy as np


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class BitWriter:
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


def random_coefs(w, h, sampling, seed, big=False):
    """(quantisation tables, coefficients): two random tables, and per
    component (h, v sampling factors) an [MCU rows * v][MCU columns * h]
    grid of blocks of 64 quantised coefficients in zigzag order, a random
    DC and about eight nonzero AC coefficients among the first 19."""
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
    return qts, coefs


def _header(w, h, sampling, ids, qts, sof: int) -> bytearray:
    out = bytearray(b"\xff\xd8")
    for i, q in enumerate(qts):
        out += segment(0xDB, bytes([i]) + bytes(int(x) for x in q))
    sof_body = struct.pack(">BHHB", 8, h, w, len(sampling))
    for i, (ch, cv) in enumerate(sampling):
        sof_body += bytes([ids[i], (ch << 4) | cv, 0 if i == 0 else 1])
    return out + segment(sof, sof_body)


def hand_jpeg(w, h, sampling, seed, restart=0, ids=(1, 2, 3),
              big=False) -> bytes:
    """A baseline JPEG of random quantised coefficients (`random_coefs`):
    components with the given (h, v) sampling factors, interleaved, DC
    codes all 4 bits and AC codes all 8 bits long (a valid, if poor,
    Huffman table)."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts, coefs = random_coefs(w, h, sampling, seed, big)
    dc_syms = list(range(12))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
    dc_code = {s: i for i, s in enumerate(dc_syms)}
    ac_code = {s: i for i, s in enumerate(ac_syms)}

    def cat(v):
        return int(abs(v)).bit_length()

    def bits(v, n):
        return v if v >= 0 else v + (1 << n) - 1

    nc = len(sampling)
    out = _header(w, h, sampling, ids, qts, 0xC0)
    counts = [0] * 16
    counts[3] = len(dc_syms)
    out += segment(0xC4, bytes([0x00] + counts) + bytes(dc_syms))
    counts = [0] * 16
    counts[7] = len(ac_syms)
    out += segment(0xC4, bytes([0x10] + counts) + bytes(ac_syms))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[i], 0x00]) for i in range(nc))
    out += segment(0xDA, sos + bytes([0, 63, 0]))
    bw = BitWriter()
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


class ArithEncoder:
    """T.81 Annex D's encoder as libjpeg's jcarith.c writes it: the C
    register with carry-over through stacked 0xFF bytes, 0x00 stuffing
    after 0xFF, and the termination of D.1.8. A statistics bin is one int,
    MPS << 7 | state index, and the state table is io/jpeg.py's (a wrong
    entry would show as PIL decoding the file to other texels)."""

    def __init__(self):
        from ..io.jpeg import ARITAB

        self.tab = ARITAB
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_stacked(self, value):
        """Write the pending byte `value` and the stacked bytes."""
        if self.zc:
            self.out += b"\x00" * self.zc
            self.zc = 0
        self._emit(value)

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe = self.tab[sv & 0x7F]
        nl, nm = qe & 0xFF, (qe >> 8) & 0xFF
        qe >>= 16
        self.a -= qe
        if val != (sv >> 7):  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation, byte output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:  # carry into the pending byte
                    if self.buffer >= 0:
                        self._flush_stacked(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_stacked(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += b"\x00" * self.zc
                            self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """Terminate (D.1.8) and return the interval's bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_stacked(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_stacked(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += b"\x00" * self.zc
                    self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b"\x00" * self.zc
                self.zc = 0
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _encode_mag(enc, st, i, mag, chain):
    """Magnitude |v| >= 1 from bin i: the category (the first decision at
    bin i, the rest from `chain` on, DC's X1 = 20 when chain is None and
    AC's two decisions at bin i first otherwise), then 14 bins beyond."""
    v = mag - 1
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if chain is None:
            i = 20
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                v2 >>= 1
                i += 1
        elif v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = chain
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                v2 >>= 1
                i += 1
    enc.encode(st, i, 0)
    i += 14
    while m > 1:
        m >>= 1
        enc.encode(st, i, 1 if v & m else 0)


def arith_jpeg(w, h, sampling, seed, restart=0, ids=(1, 2, 3),
               progressive=False, dac=None, big=False, script=None) -> bytes:
    """`random_coefs`' image arithmetic-coded (SOF9, or SOF10 with
    `progressive`: DC first at Al = 1 over all components, AC 1-5 at Al
    = 2 and 6-63 at Al = 1 a component, then every refinement down to Al
    = 0). `dac`: {(class, table): Cs}, written as a DAC segment (DC: L |
    U << 4, AC: K). Decodes to what `hand_jpeg` of the same arguments
    does. `script` replaces the progressive scans: a list of (component
    indices, Ss, Se, Ah, Al)."""
    from ..io.jpeg import FIXED_BIN, NATURAL

    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts, coefs = random_coefs(w, h, sampling, seed, big)
    nc = len(sampling)
    # the coefficients in natural order, as the decoder stores them
    zz = np.asarray(NATURAL[:64])
    nat = []
    for c in coefs:
        a = np.asarray(c, np.int64)
        b = np.empty_like(a)
        b[..., zz] = a
        nat.append(b)
    out = _header(w, h, sampling, ids, qts, 0xCA if progressive else 0xC9)
    dac = dict(dac or {})
    if dac:
        out += segment(0xCC, b"".join(bytes([(tc << 4) | tb, cs])
                                       for (tc, tb), cs in dac.items()))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    kx = dac.get((1, 0), 5)
    dc_lu = dac.get((0, 0), 0x10)
    lo, hi = dc_lu & 15, dc_lu >> 4

    def units(comps):
        if len(comps) == 1:
            ci = comps[0]
            ch, cv = sampling[ci]
            bw = -(-(-(-w * ch // hmax)) // 8)
            bh = -(-(-(-h * cv // vmax)) // 8)
            return [[(ci, by, bx)] for by in range(bh) for bx in range(bw)]
        return [[(ci, my * sampling[ci][1] + v, mx * sampling[ci][0] + hh)
                 for ci in comps for v in range(sampling[ci][1])
                 for hh in range(sampling[ci][0])]
                for my in range(mcuy) for mx in range(mcux)]

    def scan(comps, ss, se, ah, al):
        sos = bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0x00]) for ci in comps)
        body = bytearray()
        us = units(comps)
        per = restart or len(us)
        for n0 in range(0, len(us), per):
            enc = ArithEncoder()
            fixed = [FIXED_BIN]
            dc_st, ac_st = [0] * 64, [0] * 256
            pred = [0] * nc
            ctx = [0] * nc
            for unit in us[n0:n0 + per]:
                for ci, by, bx in unit:
                    blk = nat[ci][by, bx]
                    if progressive and ss == 0 and ah:
                        enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                        continue
                    if not progressive or ss == 0:
                        dc = int(blk[0]) >> al if progressive else int(blk[0])
                        diff = dc - pred[ci]
                        pred[ci] = dc
                        i = ctx[ci]
                        if diff == 0:
                            enc.encode(dc_st, i, 0)
                            ctx[ci] = 0
                        else:
                            enc.encode(dc_st, i, 1)
                            sign = int(diff < 0)
                            enc.encode(dc_st, i + 1, sign)
                            mag = abs(diff)
                            m = 0 if mag == 1 else 1 << ((mag - 1)
                                                          .bit_length() - 1)
                            _encode_mag(enc, dc_st, i + 2 + sign, mag, None)
                            if m < (1 << lo) >> 1:
                                ctx[ci] = 0
                            elif m > (1 << hi) >> 1:
                                ctx[ci] = 12 + sign * 4
                            else:
                                ctx[ci] = 4 + sign * 4
                        if progressive:
                            continue
                    k0, k1 = (ss, se) if progressive else (1, 63)
                    zb = [int(blk[NATURAL[k]]) for k in range(64)]
                    if progressive and ah:  # AC refinement
                        cur = [abs(x) >> ah for x in zb]
                        kex = k1
                        while kex > 0 and not cur[kex]:
                            kex -= 1
                        ke = k1
                        while ke > 0 and not (abs(zb[ke]) >> al):
                            ke -= 1
                        k = k0
                        while k <= ke:
                            i = 3 * (k - 1)
                            if k > kex:
                                enc.encode(ac_st, i, 0)
                            while True:
                                bit = (abs(zb[k]) >> al) & 1
                                if cur[k]:
                                    enc.encode(ac_st, i + 2, bit)
                                    break
                                if bit:
                                    enc.encode(ac_st, i + 1, 1)
                                    enc.encode(fixed, 0, int(zb[k] < 0))
                                    break
                                enc.encode(ac_st, i + 1, 0)
                                i += 3
                                k += 1
                            k += 1
                        if k <= k1:
                            enc.encode(ac_st, 3 * (k - 1), 1)
                        continue
                    sh = al if progressive else 0
                    vals = [(abs(zb[k]) >> sh) * (1 if zb[k] >= 0 else -1)
                            for k in range(64)]
                    ke = k1
                    while ke >= k0 and not vals[ke]:
                        ke -= 1
                    k = k0
                    while k <= ke:
                        i = 3 * (k - 1)
                        enc.encode(ac_st, i, 0)
                        while not vals[k]:
                            enc.encode(ac_st, i + 1, 0)
                            i += 3
                            k += 1
                        enc.encode(ac_st, i + 1, 1)
                        enc.encode(fixed, 0, int(vals[k] < 0))
                        _encode_mag(enc, ac_st, i + 2, abs(vals[k]),
                                    189 if k <= kx else 217)
                        k += 1
                    if k <= k1:
                        enc.encode(ac_st, 3 * (k - 1), 1)
            body += enc.finish()
            if restart and n0 + per < len(us):
                body += bytes([0xFF, 0xD0 + (n0 // per) % 8])
        return segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])) + body

    if not progressive:
        out += scan(list(range(nc)), 0, 63, 0, 0)
    elif script is not None:
        for comps, ss, se, ah, al in script:
            out += scan(list(comps), ss, se, ah, al)
    else:
        every = list(range(nc))
        out += scan(every, 0, 0, 0, 1)
        for ci in every:
            out += scan([ci], 1, 5, 0, 2)
            out += scan([ci], 6, 63, 0, 1)
        for ci in every:
            out += scan([ci], 1, 5, 2, 1)
            out += scan([ci], 1, 5, 1, 0)
            out += scan([ci], 6, 63, 1, 0)
        out += scan(every, 0, 0, 1, 0)
    return bytes(out + b"\xff\xd9")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="time_jpeg")
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    from ..io.jpeg import decode_jpeg

    n = args.size
    sampling = [(2, 2), (1, 1), (1, 1)]
    out = {"size": [n, n], "sampling": "4:2:0", "cases": []}
    images = []
    for coding, make in (("huffman baseline", hand_jpeg),
                         ("arithmetic sequential", arith_jpeg)):
        data = make(n, n, sampling, seed=2048)
        seconds = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            img = decode_jpeg(data)
            seconds.append(time.perf_counter() - t0)
        images.append(img)
        out["cases"].append({
            "coding": coding, "bytes": len(data),
            "bits_per_pixel": 8 * len(data) / (n * n), "decode_s": seconds,
            "min_s": min(seconds), "mean_texel": float(img[..., :3].mean())})
    out["same_texels"] = bool(np.array_equal(*images))
    print(json.dumps(out), flush=True)
    if not out["same_texels"]:
        raise AssertionError("the two codings decode to different texels")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
