"""JPEG decoding in numpy, for glTF textures (the JAX package decodes them
with PIL, which the port's GPU host lacks).

`decode_jpeg(data) -> uint8 [H, W, 4]` returns what PIL's
`Image.open(...).convert("RGBA")` returns for the same file when PIL is
built on libjpeg-turbo, and `jpeg_rgba` that divided by 255 as float32,
the texture format of scene/gltf.py. A texture must decode to the same
texels in both packages, so every stage copies libjpeg-turbo's default
decode path rather than an ideal one:

  * the integer "islow" inverse DCT of jidctint.c: its 13-bit constants,
    the 2 extra bits of pass 1, the rounding shifts of both passes and
    the range limit, with the 16-bit storage and saturating clamp of its
    x86 SIMD version, which PIL runs (`idct_islow` says where the two
    differ);
  * fancy chroma upsampling (jdsample.c): h2v1 and h2v2 triangle filters
    with their rounding biases (1/2 and 8/7), h1v2 with 1/2, the edges
    replicated (the last real row and column of the plane), and plain
    box replication where the filter does not apply (a plane at most 2
    samples wide, other integer ratios);
  * YCbCr -> RGB through jdcolor.c's 16-bit fixed-point tables.

Supported: every kind PIL reads there. Baseline and extended sequential
Huffman (SOF0/SOF1), progressive Huffman (SOF2), and their
arithmetic-coded twins (SOF9/SOF10, DAC conditioning; jdarith.c's
decoder of T.81 Annex D, F and G); 8-bit lossless (SOF3: predictors 1-7,
the point transform, restart intervals of whole MCU rows, one-sample
"blocks" replicated, not fancy-upsampled); 1, 3 or 4 components (CMYK,
and YCCK through jdcolor.c's tables, then PIL's inverted Adobe CMYK and
its cmyk2rgb); any integer sampling ratio; restart intervals; several
scans; sizes with partial MCUs. Progressive scans follow jdphuff.c and
jdarith.c: EOB runs, successive-approximation refinement of DC and AC
bits, and predictors and EOB runs reset at each restart. A progressive
file whose coefficients 1-9 are not all known exactly (a script that
stops short) goes through libjpeg-turbo's block smoothing (jdcoefct.c
decompress_smooth_data, a 5x5 neighbourhood of DC values). Refused,
with NotImplementedError naming the reason, as PIL refuses them:
precisions other than 8 bits, hierarchical files (SOF5-7, SOF13-15),
lossless arithmetic coding (SOF11), 2-component images, non-integer
sampling ratios, lossless files that need a colour conversion (YCbCr,
YCCK) or have restart intervals that are not whole MCU rows. Malformed
data raises ValueError.

The entropy decode is a Python loop over symbols (Huffman: a 16-bit
lookup table per code, a 24-bit window per byte) or over binary
decisions (arithmetic), so it is the slow part, with the lossless
predictors 6-7 and block smoothing, which loop over samples and blocks:
time it on the host that decodes (PERF.md has a 2048x2048 texture's
times). The rest is vectorised over blocks and pixels.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag index -> natural (row-major) index, with libjpeg's 16 guard
# entries for runs past the end of a corrupt block
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16

# the frames decoded: SOF marker -> (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}
# the frames libjpeg-turbo (and so PIL) refuses as well
_UNSUPPORTED_SOF = {
    0xC5: "hierarchical (differential) JPEG",
    0xC6: "hierarchical (differential) JPEG",
    0xC7: "hierarchical (differential) JPEG",
    0xCB: "lossless arithmetic-coded JPEG",
    0xCD: "hierarchical (differential) JPEG",
    0xCE: "hierarchical (differential) JPEG",
    0xCF: "hierarchical (differential) JPEG",
}


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _huffman_lut(counts, symbols) -> list:
    """65536-entry table: (code length << 8) | symbol for every 16-bit
    window whose leading bits are a code; 0 where none is."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, pos: int):
    """Entropy-coded data from `pos` up to the next marker that is not a
    restart: (list of restart intervals' bytes, unstuffed, position of
    that marker)."""
    segs, start, end = [], pos, None
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            segs.append(data[start:end if end is not None else n])
            return [s.replace(b"\xff\x00", b"\xff") for s in segs], n
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
            continue
        if end is None:
            end = i
        if nxt == 0xFF:  # fill bytes before a marker
            pos = i + 1
            continue
        if 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:end])
            start = pos = i + 2
            end = None
            continue
        segs.append(data[start:end])
        return [s.replace(b"\xff\x00", b"\xff") for s in segs], i


def _windows(seg: bytes) -> list:
    """The 24 bits from each byte of one restart interval on, zeros past
    its end (libjpeg's fill): the 16 bits from bit `pos` on are
    (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _units(frame, scan_comps, size=64):
    """The scan's MCUs in order, each a list of (component, offset of a
    data unit of `size` values in its flat list): one unit an MCU over a
    component's real blocks in a one-component scan, the sampling
    factors' units of each component an MCU in an interleaved one."""
    if len(scan_comps) == 1:
        c = scan_comps[0]
        return [[(c, (by * c.pbw + bx) * size)] for by in range(c.bh)
                for bx in range(c.bw)]
    units = []
    for my in range(frame["mcuy"]):
        for mx in range(frame["mcux"]):
            u = []
            for c in scan_comps:
                for v in range(c.v):
                    for h in range(c.h):
                        u.append((c, ((my * c.v + v) * c.pbw + mx * c.h + h)
                                  * size))
            units.append(u)
    return units


def _intervals(units, segs, restart):
    """(first MCU, MCUs, entropy-coded bytes) of each restart interval."""
    per = restart if restart else len(units)
    nseg = (len(units) + per - 1) // per if units else 0
    segs = segs + [b""] * max(0, nseg - len(segs))
    return [(i * per, min(per, len(units) - i * per), segs[i])
            for i in range(nseg)]


def _scan(frame, scan_comps, ss, se, ah, al, segs, restart, coefs, luts):
    """Decode one scan into `coefs` (a flat list per component, 64 ints a
    block in natural order, blocks row-major over the padded block grid)."""
    progressive = frame["progressive"]
    units = _units(frame, scan_comps)
    for first, count, seg in _intervals(units, segs, restart):
        w = _windows(seg)
        pos = 0
        pred = {c.id: 0 for c in scan_comps}
        eobrun = 0
        for unit in units[first:first + count]:
            for c, base in unit:
                out = coefs[c.id]
                if not progressive:
                    lut = luts[0][c.td]
                    e = lut[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("bad Huffman code")
                    pos += e >> 8
                    s = e & 0xFF
                    if s:
                        r = ((w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (
                            16 - s)
                        pos += s
                        pred[c.id] += _extend(r, s)
                    out[base] = pred[c.id]
                    lut = luts[1][c.ta]
                    k = 1
                    while k < 64:
                        e = lut[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("bad Huffman code")
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = ((w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                                 ) >> (16 - s)
                            pos += s
                            out[base + NATURAL[k]] = (
                                v - (1 << s) + 1 if v < (1 << (s - 1))
                                else v)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                elif ss == 0:  # progressive DC
                    if ah == 0:
                        lut = luts[0][c.td]
                        e = lut[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("bad Huffman code")
                        pos += e >> 8
                        s = e & 0xFF
                        if s:
                            r = ((w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                                 ) >> (16 - s)
                            pos += s
                            pred[c.id] += _extend(r, s)
                        out[base] = pred[c.id] << al
                    else:
                        if (w[pos >> 3] >> (23 - (pos & 7))) & 1:
                            out[base] |= 1 << al
                        pos += 1
                elif ah == 0:  # progressive AC, first pass
                    if eobrun:
                        eobrun -= 1
                        continue
                    lut = luts[1][c.ta]
                    k = ss
                    while k <= se:
                        e = lut[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("bad Huffman code")
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = ((w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                                 ) >> (16 - s)
                            pos += s
                            out[base + NATURAL[k]] = _extend(v, s) << al
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += ((w[pos >> 3] >> (8 - (pos & 7)))
                                           & 0xFFFF) >> (16 - r)
                                pos += r
                            eobrun -= 1
                            break
                        k += 1
                else:  # progressive AC, refinement
                    p1 = 1 << al
                    m1 = -1 << al
                    k = ss
                    if eobrun == 0:
                        lut = luts[1][c.ta]
                        while k <= se:
                            e = lut[(w[pos >> 3] >> (8 - (pos & 7)))
                                    & 0xFFFF]
                            if not e:
                                raise ValueError("bad Huffman code")
                            pos += e >> 8
                            rs = e & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s:
                                bit = (w[pos >> 3] >> (23 - (pos & 7))) & 1
                                pos += 1
                                s = p1 if bit else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += ((w[pos >> 3]
                                                >> (8 - (pos & 7)))
                                               & 0xFFFF) >> (16 - r)
                                    pos += r
                                break
                            while k <= se:
                                idx = base + NATURAL[k]
                                cv = out[idx]
                                if cv:
                                    bit = (w[pos >> 3] >> (23 - (pos & 7))) & 1
                                    pos += 1
                                    if bit and not (cv & p1):
                                        out[idx] = cv + (p1 if cv >= 0
                                                         else m1)
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                out[base + NATURAL[k]] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            idx = base + NATURAL[k]
                            cv = out[idx]
                            if cv:
                                bit = (w[pos >> 3] >> (23 - (pos & 7))) & 1
                                pos += 1
                                if bit and not (cv & p1):
                                    out[idx] = cv + (p1 if cv >= 0 else m1)
                            k += 1
                        eobrun -= 1


def _lossless_scan(frame, scan_comps, psv, pt, segs, restart, diffs, luts):
    """One lossless Huffman scan (jdlhuff.c): a difference per sample,
    category 16 meaning 32768 with no extra bits, into `diffs` (a flat
    list per component over its padded sample grid). Records on each
    component its predictor, point transform and the sample rows where a
    restart interval begins (the predictor restarts there)."""
    units = _units(frame, scan_comps, size=1)
    per_row = scan_comps[0].bw if len(scan_comps) == 1 else frame["mcux"]
    if restart % per_row:
        raise NotImplementedError(
            "lossless JPEG with restart intervals that are not whole MCU "
            "rows is not supported (nor by libjpeg-turbo)")
    if not 1 <= psv <= 7:
        raise ValueError(f"bad lossless predictor {psv}")
    for c in scan_comps:
        c.lossless = (psv, pt, set())
    for first, count, seg in _intervals(units, segs, restart):
        w = _windows(seg)
        pos = 0
        starts = {}
        for c, off in units[first] if units else []:
            starts.setdefault(c.id, (c, off // c.pbw))
        for c, row in starts.values():
            c.lossless[2].add(row)
        for unit in units[first:first + count]:
            for c, off in unit:
                lut = luts[0][c.td]
                e = lut[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("bad Huffman code")
                pos += e >> 8
                s = e & 0xFF
                if s == 16:
                    d = 32768
                elif s:
                    r = ((w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    pos += s
                    d = _extend(r, s)
                else:
                    d = 0
                diffs[c.id][off] = d


def _undifference(diff: np.ndarray, psv: int, pt: int, reset_rows) -> np.ndarray:
    """jdpred.c: samples from differences [rows, cols] (int64), modulo
    2^16; a row where the prediction restarts (the first, and each restart
    interval's) predicts from its left neighbour and 2^(7 - pt) at its
    start, every other row its first sample from above and the rest by
    predictor `psv` (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + (Rb - Rc) /
    2, 6 Rb + (Ra - Rc) / 2, 7 (Ra + Rb) / 2, halves by arithmetic shift);
    then shifted left by the point transform and cast to 8 bits."""
    rows, cols = diff.shape
    out = np.empty_like(diff)
    mask = 0xFFFF
    for r in range(rows):
        d = diff[r]
        if r == 0 or r in reset_rows:
            d = d.copy()
            d[0] += 1 << (7 - pt)
            out[r] = np.cumsum(d) & mask
            continue
        rb = out[r - 1]
        rc = np.concatenate([[0], rb[:-1]])
        if psv in (1, 4, 5):  # linear in Ra: a running sum
            extra = {1: 0, 4: rb - rc, 5: (rb - rc) >> 1}[psv]
            t = d + extra
            t[0] = d[0] + rb[0]
            out[r] = np.cumsum(t) & mask
        elif psv in (2, 3):  # no Ra at all
            out[r] = (d + (rb if psv == 2 else rc)) & mask
            out[r, 0] = (d[0] + rb[0]) & mask
        else:
            row = out[r]
            dl, bl, cl = d.tolist(), rb.tolist(), rc.tolist()
            ra = (dl[0] + bl[0]) & mask
            row[0] = ra
            for x in range(1, cols):
                if psv == 6:
                    ra = (dl[x] + bl[x] + ((ra - cl[x]) >> 1)) & mask
                else:
                    ra = (dl[x] + ((ra + bl[x]) >> 1)) & mask
                row[x] = ra
    return (out << pt) & 0xFF


# jaricom.c / T.81 Table D.2: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
_QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]  # (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
ARITAB = [(qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in _QE]
FIXED_BIN = 113  # the non-adapting estimate (signs, DC refinement bits)


class _ArithDecoder:
    """jdarith.c's arith_decode (T.81 D.2) over one restart interval's
    unstuffed bytes, zeros past their end. A statistics bin is one int,
    MPS << 7 | state index."""

    def __init__(self, seg: bytes):
        self.data = seg
        self.pos = 0
        self.c = self.a = 0
        self.ct = -16  # two bytes fill C before the first decision

    def decode(self, st: list, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = self.data
                byte = data[self.pos] if self.pos < len(data) else 0
                self.pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # two initial bytes in: A = 0x10000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the MPS after all
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _s16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _arith_scan(frame, scan_comps, ss, se, ah, al, segs, restart, coefs,
                dac):
    """Decode one arithmetic-coded scan into `coefs` (jdarith.c: sequential
    and the four progressive scan kinds). Each scan, and each restart
    interval, starts the statistics of its tables, the DC predictions and
    the decoder afresh; conditioning comes from DAC, by default L = 0,
    U = 1 and K = 5."""
    progressive = frame["progressive"]
    units = _units(frame, scan_comps)
    dc_first = not progressive or ss == 0
    ac_any = not progressive or ss > 0
    for first, count, seg in _intervals(units, segs, restart):
        dec = _ArithDecoder(seg)
        fixed = [FIXED_BIN]
        dc_stats = {c.td: [0] * 64 for c in scan_comps}
        ac_stats = {c.ta: [0] * 256 for c in scan_comps}
        pred = {c.id: 0 for c in scan_comps}
        ctx = {c.id: 0 for c in scan_comps}
        for unit in units[first:first + count]:
            for c, base in unit:
                out = coefs[c.id]
                if progressive and ss == 0 and ah:  # DC refinement bit
                    if dec.decode(fixed, 0):
                        out[base] |= 1 << al
                    continue
                if dc_first:
                    st = dc_stats[c.td]
                    i = ctx[c.id]
                    if dec.decode(st, i) == 0:
                        ctx[c.id] = 0
                    else:
                        sign = dec.decode(st, i + 1)
                        i += 2 + sign
                        m = dec.decode(st, i)
                        if m:
                            j = 20
                            while dec.decode(st, j):
                                m <<= 1
                                if m == 0x8000:
                                    raise ValueError("bad arithmetic code")
                                j += 1
                            i = j
                        lo, hi = dac[0].get(c.td, (0, 1))
                        if m < (1 << lo) >> 1:
                            ctx[c.id] = 0
                        elif m > (1 << hi) >> 1:
                            ctx[c.id] = 12 + sign * 4
                        else:
                            ctx[c.id] = 4 + sign * 4
                        v = m
                        i += 14
                        while m > 1:
                            m >>= 1
                            if dec.decode(st, i):
                                v |= m
                        v += 1
                        pred[c.id] = (pred[c.id] + (-v if sign else v)) \
                            & 0xFFFF
                    out[base] = _s16(pred[c.id] << (al if progressive
                                                    else 0))
                    if progressive:
                        continue
                if not ac_any:
                    continue
                st = ac_stats[c.ta]
                kx = dac[1].get(c.ta, 5)
                lo_k, hi_k = (ss, se) if progressive else (1, 63)
                if progressive and ah:  # AC refinement
                    p1, m1 = 1 << al, -1 << al
                    kex = hi_k
                    while kex > 0 and not out[base + NATURAL[kex]]:
                        kex -= 1
                    k = lo_k - 1
                    while k < hi_k:
                        i = 3 * k
                        if k >= kex and dec.decode(st, i):
                            break
                        while True:
                            idx = base + NATURAL[k + 1]
                            if out[idx]:
                                if dec.decode(st, i + 2):
                                    out[idx] += m1 if out[idx] < 0 else p1
                                break
                            if dec.decode(st, i + 1):
                                out[idx] = m1 if dec.decode(fixed, 0) else p1
                                break
                            i += 3
                            k += 1
                            if k >= hi_k:
                                raise ValueError("bad arithmetic code "
                                                 "(spectral overflow)")
                        k += 1
                    continue
                k = lo_k - 1
                while k < hi_k:
                    i = 3 * k
                    if dec.decode(st, i):  # end of block
                        break
                    while True:
                        k += 1
                        if dec.decode(st, i + 1):
                            break
                        i += 3
                        if k >= hi_k:
                            raise ValueError("bad arithmetic code "
                                             "(spectral overflow)")
                    sign = dec.decode(fixed, 0)
                    i += 2
                    m = dec.decode(st, i)
                    if m and dec.decode(st, i):
                        m <<= 1
                        i = 189 if k <= kx else 217
                        while dec.decode(st, i):
                            m <<= 1
                            if m == 0x8000:
                                raise ValueError("bad arithmetic code")
                            i += 1
                    v = m
                    i += 14
                    while m > 1:
                        m >>= 1
                        if dec.decode(st, i):
                            v |= m
                    v += 1
                    out[base + NATURAL[k]] = _s16((-v if sign else v) << al)


# natural positions of the DC and the first nine AC coefficients (zigzag
# 0-9): Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30
_SMOOTH_POS = NATURAL[:10]


def _smoothing_ok(frame, qts, coef_bits) -> bool:
    """jdcoefct.c smoothing_ok: every component has a quantisation table
    with nonzero steps at the ten positions and some DC bits, and some
    component's coefficients 1-9 are not known exactly (coef_bits, the
    last point transform sent for each, -1 never sent, nonzero)."""
    useful = False
    for c in frame["comps"]:
        q = qts.get(c.tq)
        if q is None or not all(q[p] for p in _SMOOTH_POS):
            return False
        bits = coef_bits[c.id]
        if bits[0] < 0:
            return False
        useful = useful or any(bits[k] != 0 for k in range(1, 10))
    return useful


def _estimate(num: int, q: int, al: int) -> int:
    """One smoothed coefficient: num / (q * 256) rounded half away from
    zero in magnitude, capped below 2^Al when Al > 0."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if al > 0 and pred >= 1 << al:
        pred = (1 << al) - 1
    return pred if num >= 0 else -pred


def _smooth(frame, c, coefs, q, bits) -> np.ndarray:
    """libjpeg-turbo's decompress_smooth_data (jdcoefct.c) over one
    component: blocks [pbh, pbw, 64] (natural order) -> the blocks the
    IDCT gets. Each real block whose coefficients 1-9 are zero but not
    exactly known gets estimates from the DC values of the 5x5 blocks
    around it (columns and rows past the edges clamped, except that a
    row of an earlier iMCU row reaches the dummy rows that pad the last
    one: coded in an interleaved scan, zero in a one-component frame);
    with no AC data at all for 1-9 the Gaussian-like kernel also
    re-estimates the DC and AC03-AC30."""
    out = coefs.copy()
    v = c.v
    last_imcu = -(-frame["height"] // (8 * frame["vmax"])) - 1
    if len(frame["comps"]) == 1:
        last_imcu = -(-c.hgt // (8 * v)) - 1
    last_col = c.bw - 1
    change_dc = all(bits[k] == -1 for k in range(1, 10))
    # the coefficient array's rows: whole iMCU rows, the dummy blocks of
    # the last one as decoded (an interleaved scan codes them) or zero
    n_rows = (last_imcu + 1) * v
    dc = np.zeros((max(n_rows, coefs.shape[0]), c.bw), np.int64)
    dc[:coefs.shape[0]] = coefs[:, :c.bw, 0]
    qv = [int(q[p]) for p in _SMOOTH_POS]
    q00 = qv[0]
    for imcu in range(last_imcu + 1):
        if imcu < last_imcu:
            block_rows = v
        else:
            block_rows = c.bh % v or v
        for br in range(block_rows):
            r = imcu * v + br
            if imcu < last_imcu:  # may reach the last iMCU row's dummies
                nxt = r + 1
                nnxt = r + 2 if r + 2 < n_rows else nxt
            else:  # the last iMCU row's real rows only
                nxt = r + 1 if br < block_rows - 1 else r
                nnxt = r + 2 if br < block_rows - 2 else nxt
            sub = dc[[max(r - 2, 0), max(r - 1, 0), r, nxt, nnxt]]
            for b in range(c.bw):
                cols = [min(max(b + i, 0), last_col) for i in (-2, -1, 0, 1,
                                                               2)]
                (d01, d02, d03, d04, d05), (d06, d07, d08, d09, d10), \
                    (d11, d12, d13, d14, d15), (d16, d17, d18, d19, d20), \
                    (d21, d22, d23, d24, d25) = sub[:, cols].tolist()
                blk = out[r, b]
                if change_dc:
                    n01 = (-d01 - d02 + d04 + d05 - 3 * d06 + 13 * d07
                           - 13 * d09 + 3 * d10 - 3 * d11 + 38 * d12
                           - 38 * d14 + 3 * d15 - 3 * d16 + 13 * d17
                           - 13 * d19 + 3 * d20 - d21 - d22 + d24 + d25)
                    n10 = (-d01 - 3 * d02 - 3 * d03 - 3 * d04 - d05 - d06
                           + 13 * d07 + 38 * d08 + 13 * d09 - d10 + d16
                           - 13 * d17 - 38 * d18 - 13 * d19 + d20 + d21
                           + 3 * d22 + 3 * d23 + 3 * d24 + d25)
                    n20 = (d03 + 2 * d07 + 7 * d08 + 2 * d09 - 5 * d12
                           - 14 * d13 - 5 * d14 + 2 * d17 + 7 * d18
                           + 2 * d19 + d23)
                    n11 = (-d01 + d05 + 9 * d07 - 9 * d09 - 9 * d17
                           + 9 * d19 + d21 - d25)
                    n02 = (2 * d07 - 5 * d08 + 2 * d09 + d11 + 7 * d12
                           - 14 * d13 + 7 * d14 + d15 + 2 * d17 - 5 * d18
                           + 2 * d19)
                else:
                    n01 = -7 * d11 + 50 * d12 - 50 * d14 + 7 * d15
                    n10 = -7 * d03 + 50 * d08 - 50 * d18 + 7 * d23
                    n20 = -d03 + 13 * d08 - 24 * d13 + 13 * d18 - d23
                    n11 = (d10 + d16 - 10 * d17 + 10 * d19 - d02 - d20
                           + d22 - d24 + d04 - d06 + 10 * d07 - 10 * d09)
                    n02 = -d11 + 13 * d12 - 24 * d13 + 13 * d14 - d15
                nums = [n01, n10, n20, n11, n02]
                if change_dc:
                    nums += [d07 - d09 + 2 * d12 - 2 * d14 + d17 - d19,
                             d07 - 3 * d08 + d09 - d17 + 3 * d18 - d19,
                             d07 - d09 - 3 * d12 + 3 * d14 + d17 - d19,
                             d07 + 2 * d08 + d09 - d17 - 2 * d18 - d19]
                for k, n in enumerate(nums, start=1):
                    pos = _SMOOTH_POS[k]
                    if bits[k] != 0 and blk[pos] == 0:
                        blk[pos] = _estimate(q00 * n, qv[k], bits[k])
                if change_dc:
                    n00 = (-2 * d01 - 6 * d02 - 8 * d03 - 6 * d04 - 2 * d05
                           - 6 * d06 + 6 * d07 + 42 * d08 + 6 * d09
                           - 6 * d10 - 8 * d11 + 42 * d12 + 152 * d13
                           + 42 * d14 - 8 * d15 - 6 * d16 + 6 * d17
                           + 42 * d18 + 6 * d19 - 6 * d20 - 2 * d21
                           - 6 * d22 - 8 * d23 - 6 * d24 - 2 * d25)
                    blk[0] = _estimate(q00 * n00, q00, 0)
    return out


# jidctint.c constants (CONST_BITS = 13)
_F = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
          c1175=9633, c1501=12299, c1847=15137, c1961=16069, c2053=16819,
          c2562=20995, c3072=25172)


def _idct_1d(x):
    """One jidctint.c pass over axis 1 of x [N, 8, ...] (int64); returns
    the 8 outputs before their final descale."""
    f = _F
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * f["c0541"]
    tmp2 = z1 + z3 * -f["c1847"]
    tmp3 = z1 + z2 * f["c0765"]
    z2, z3 = x[:, 0], x[:, 4]
    tmp0 = (z2 + z3) << 13
    tmp1 = (z2 - z3) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["c1175"]
    t0 = t0 * f["c0298"]
    t1 = t1 * f["c2053"]
    t2 = t2 * f["c3072"]
    t3 = t3 * f["c1501"]
    z1 = z1 * -f["c0899"]
    z2 = z2 * -f["c2562"]
    z3 = z3 * -f["c1961"] + z5
    z4 = z4 * -f["c0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)


def _int16(x, saturate: bool):
    if saturate:
        return np.clip(x, -32768, 32767)
    return ((x + 32768) & 0xFFFF) - 32768


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's islow IDCT over blocks: coef [N, 64] natural order,
    qt [64] natural order -> uint8 [N, 8, 8] samples. The arithmetic is
    jidctint.c's; the storage is its x86 SIMD version's (the one PIL runs
    there): 16-bit dequantised coefficients (the product's low 16 bits),
    16-bit saturated pass-1 results, and a saturating final clamp where
    the C code's range-limit table wraps. They differ only on
    coefficients no 8-bit image produces."""
    x = _int16(coef.astype(np.int64) * qt.astype(np.int64), False)
    ws = (_idct_1d(x.reshape(-1, 8, 8)) + (1 << 10)) >> 11  # columns
    ws = _int16(ws, True)
    out = (_idct_1d(ws.transpose(0, 2, 1)) + (1 << 17)) >> 18  # rows
    out = out.transpose(0, 2, 1)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c's default method for one component plane (int64,
    cropped to its downsampled size) by factors (fh, fv)."""
    if (fh, fv) == (1, 1):
        return plane
    w = plane.shape[1]
    fancy_h = fh == 2 and w > 2
    if (fh, fv) == (2, 1) and fancy_h:
        p = np.pad(plane, ((0, 0), (1, 1)), mode="edge")
        c3 = 3 * p[:, 1:-1]
        out = np.empty((plane.shape[0], 2 * w), np.int64)
        out[:, 0::2] = (c3 + p[:, :-2] + 1) >> 2
        out[:, 1::2] = (c3 + p[:, 2:] + 2) >> 2
        return out
    if (fh, fv) == (1, 2):
        p = np.pad(plane, ((1, 1), (0, 0)), mode="edge")
        c3 = 3 * p[1:-1]
        out = np.empty((2 * plane.shape[0], w), np.int64)
        out[0::2] = (c3 + p[:-2] + 1) >> 2
        out[1::2] = (c3 + p[2:] + 2) >> 2
        return out
    if (fh, fv) == (2, 2) and fancy_h:
        p = np.pad(plane, ((1, 1), (0, 0)), mode="edge")
        near = 3 * p[1:-1]
        rows = np.empty((2 * plane.shape[0], w), np.int64)
        rows[0::2] = near + p[:-2]  # column sums with the row above
        rows[1::2] = near + p[2:]  # ... and below
        q = np.pad(rows, ((0, 0), (1, 1)), mode="edge")
        c3 = 3 * q[:, 1:-1]
        out = np.empty((rows.shape[0], 2 * w), np.int64)
        out[:, 0::2] = (c3 + q[:, :-2] + 8) >> 4
        out[:, 1::2] = (c3 + q[:, 2:] + 7) >> 4
        return out
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert: 16-bit fixed-point tables."""
    one_half = 1 << 15
    fix = lambda v: int(v * 65536 + 0.5)
    xcb, xcr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * xcr + one_half) >> 16)
    g = y + ((-fix(0.34414) * xcb + one_half - fix(0.71414) * xcr) >> 16)
    b = y + ((fix(1.77200) * xcb + one_half) >> 16)
    return [np.clip(c, 0, 255) for c in (r, g, b)]


def _cmyk_to_rgb(planes, ycck: bool) -> np.ndarray:
    """PIL's RGB of a 4-component file: libjpeg's CMYK output (YCCK through
    jdcolor.c's ycck_cmyk_convert: the YCbCr -> RGB tables, then 255 - x;
    K as stored), read by PIL as inverted Adobe CMYK ("CMYK;I": 255 - x),
    then Convert.c's cmyk2rgb: nk = 255 - k, each channel nk - x * nk / 255
    (MULDIV255's rounding)."""
    if ycck:
        cmy = [255 - c for c in _ycc_to_rgb(*planes[:3])]
    else:
        cmy = list(planes[:3])
    c, m, y, k = (255 - x for x in (*cmy, planes[3]))
    nk = 255 - k
    out = []
    for x in (c, m, y):
        tmp = x * nk + 128
        out.append(np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255))
    return np.stack(out, -1)


def _parse(data: bytes, name: str):
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    qts, luts = {}, ({}, {})
    frame = None
    coefs = {}
    restart = 0
    dac = ({}, {})  # DC (L, U) and AC K by table; T.81's defaults below
    jfif = adobe = False
    adobe_transform = None
    coef_bits = None
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated marker segment")
        (length,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(
                f"{name}: {_UNSUPPORTED_SOF[marker]} is not supported")
        if marker in _SOF:
            progressive, arith, lossless = _SOF[marker]
            bs = 1 if lossless else 8  # samples a block side
            precision, height, width, nc = struct.unpack_from(">BHHB", body)
            if precision != 8:
                raise NotImplementedError(
                    f"{name}: {precision}-bit samples are not supported "
                    "(8-bit only)")
            if nc not in (1, 3, 4):
                raise NotImplementedError(
                    f"{name}: {nc}-component JPEG is not supported")
            if height == 0 or width == 0:
                raise ValueError(f"{name}: empty image (or DNL height)")
            comps = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", body, 6 + 3 * i)
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (bs * hmax))
            mcuy = -(-height // (bs * vmax))
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError(f"{name}: bad sampling factors")
                c.w = -(-width * c.h // hmax)  # downsampled size
                c.hgt = -(-height * c.v // vmax)
                c.bw, c.bh = -(-c.w // bs), -(-c.hgt // bs)
                c.pbw, c.pbh = mcux * c.h, mcuy * c.v
                if nc == 1:  # one block an MCU
                    c.pbw, c.pbh = c.bw, c.bh
                # a lossless "block" is one sample difference
                coefs[c.id] = [0] * (c.pbw * c.pbh * (1 if lossless else 64))
            if nc == 1:
                mcux, mcuy = comps[0].bw, comps[0].bh
            frame = dict(width=width, height=height, comps=comps,
                         hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy,
                         progressive=progressive, arith=arith,
                         lossless=lossless)
            coef_bits = {c.id: [-1] * 64 for c in comps}
        elif marker == 0xC4:  # DHT
            off = 0
            while off < len(body):
                tc_th = body[off]
                counts = list(body[off + 1:off + 17])
                total = sum(counts)
                symbols = list(body[off + 17:off + 17 + total])
                if (tc_th >> 4) > 1:
                    raise ValueError(f"{name}: bad Huffman table class")
                luts[tc_th >> 4][tc_th & 15] = _huffman_lut(counts, symbols)
                off += 17 + total
        elif marker == 0xDB:  # DQT
            off = 0
            while off < len(body):
                pq_tq = body[off]
                if pq_tq >> 4:
                    vals = struct.unpack_from(">64H", body, off + 1)
                    off += 129
                else:
                    vals = list(body[off + 1:off + 65])
                    off += 65
                q = np.zeros(64, np.int64)
                q[NATURAL[:64]] = np.asarray(vals, np.int64)
                qts[pq_tq & 15] = q
        elif marker == 0xCC:  # DAC: arithmetic conditioning
            for off in range(0, len(body) - 1, 2):
                tc_tb, cs = body[off], body[off + 1]
                if tc_tb >> 4:
                    dac[1][tc_tb & 15] = cs  # AC: K
                else:
                    dac[0][tc_tb & 15] = (cs & 15, cs >> 4)  # DC: (L, U)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", body)
        elif marker == 0xE0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                adobe, adobe_transform = True, body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: scan before frame header")
            ns = body[0]
            by_id = {c.id: c for c in frame["comps"]}
            scan_comps = []
            for i in range(ns):
                cid, tdta = body[1 + 2 * i], body[2 + 2 * i]
                c = by_id[cid]
                c.td, c.ta = tdta >> 4, tdta & 15
                scan_comps.append(c)
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            segs, pos = _segments(data, pos)
            if frame["lossless"]:  # Ss: the predictor, Al: point transform
                if frame["arith"]:
                    raise NotImplementedError(
                        f"{name}: lossless arithmetic-coded JPEG is not "
                        "supported")
                _lossless_scan(frame, scan_comps, ss, al, segs, restart,
                               coefs, luts)
                continue
            if not frame["progressive"]:
                ss, se, ah, al = 0, 63, 0, 0
            for c in scan_comps:
                for k in range(ss, se + 1):
                    coef_bits[c.id][k] = al
            if frame["arith"]:
                _arith_scan(frame, scan_comps, ss, se, ah, al, segs, restart,
                            coefs, dac)
            else:
                _scan(frame, scan_comps, ss, se, ah, al, segs, restart,
                      coefs, luts)
        # APPn, COM, DNL and the rest: skipped
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    frame["smooth"] = (frame["progressive"]
                       and _smoothing_ok(frame, qts, coef_bits))
    frame["coef_bits"] = coef_bits
    return frame, coefs, qts, _color_space(frame, jfif, adobe,
                                           adobe_transform)


def _color_space(frame, jfif: bool, adobe: bool, transform) -> str:
    """libjpeg's default_decompress_parms: "gray", "ycc", "rgb", "cmyk" or
    "ycck" from the component count, the JFIF and Adobe markers and the
    component ids."""
    nc = len(frame["comps"])
    if nc == 1:
        return "gray"
    if nc == 3:
        if jfif:
            return "ycc"
        if adobe:
            return "rgb" if transform == 0 else "ycc"
        ids = tuple(c.id for c in frame["comps"])
        # libjpeg-turbo takes a lossless file without markers as RGB
        return ("rgb" if ids == (82, 71, 66) or frame["lossless"]
                else "ycc")
    # four components: CMYK unless an Adobe marker says otherwise (any
    # transform but 0 means YCCK)
    return "ycck" if adobe and transform != 0 else "cmyk"


def decode_jpeg(data: bytes, name: str = "JPEG image") -> np.ndarray:
    """uint8 [H, W, 4]: PIL's `convert("RGBA")` of the file (libjpeg-turbo
    default decode), alpha 255."""
    frame, coefs, qts, space = _parse(bytes(data), name)
    if frame["lossless"] and space in ("ycc", "ycck"):
        raise NotImplementedError(
            f"{name}: colour conversion of a lossless JPEG ({space}) is not "
            "supported (nor by libjpeg-turbo)")
    width, height = frame["width"], frame["height"]
    planes = []
    for c in frame["comps"]:
        fh, fv = frame["hmax"] // c.h, frame["vmax"] // c.v
        if fh * c.h != frame["hmax"] or fv * c.v != frame["vmax"]:
            raise NotImplementedError(
                f"{name}: non-integer sampling ratios are not supported")
        if frame["lossless"]:
            if not hasattr(c, "lossless"):
                raise ValueError(f"{name}: component {c.id} has no scan")
            psv, pt, resets = c.lossless
            diff = np.asarray(coefs[c.id], np.int64).reshape(c.pbh, c.pbw)
            plane = _undifference(diff[:c.hgt, :c.w], psv, pt, resets)
            # one-sample "blocks": libjpeg's fancy upsampling needs DCT
            # blocks larger than 1, so a lossless plane is replicated
            planes.append(np.repeat(np.repeat(plane, fv, 0), fh, 1)[
                :height, :width])
            continue
        if c.tq not in qts:
            raise ValueError(f"{name}: missing quantisation table {c.tq}")
        blocks = np.asarray(coefs[c.id], np.int64).reshape(-1, 64)
        if frame["smooth"]:
            blocks = _smooth(frame, c, blocks.reshape(c.pbh, c.pbw, 64),
                             qts[c.tq], frame["coef_bits"][c.id]
                             ).reshape(-1, 64)
        samples = idct_islow(blocks, qts[c.tq])
        plane = samples.reshape(c.pbh, c.pbw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.pbh * 8, c.pbw * 8)[:c.hgt, :c.w]
        up = _upsample(plane.astype(np.int64), fh, fv)
        planes.append(up[:height, :width])
    out = np.full((height, width, 4), 255, np.uint8)
    if space == "gray":
        out[..., :3] = planes[0][..., None]
    elif space == "rgb":
        out[..., :3] = np.stack(planes, -1)
    elif space == "ycc":
        out[..., :3] = np.stack(_ycc_to_rgb(*planes), -1)
    else:
        out[..., :3] = _cmyk_to_rgb(planes, space == "ycck")
    return out


def jpeg_rgba(data: bytes, name: str = "JPEG image") -> np.ndarray:
    """float32 [H, W, 4] in [0, 1]: decode_jpeg / 255, as the JAX package
    turns PIL's RGBA into a texture."""
    return decode_jpeg(data, name).astype(np.float32) / 255.0
