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

Supported: baseline and extended sequential Huffman (SOF0/SOF1) and
progressive Huffman (SOF2), 8-bit samples, 1 or 3 components, any
integer sampling ratio (4:4:4, 4:2:2, 4:2:0, 4:4:0 ...), restart
intervals, several scans, sizes with partial MCUs. Progressive scans
follow jdphuff.c: EOB runs, successive-approximation refinement of DC
and AC bits, and predictors and EOB runs reset at each restart. A
complete progressive file decodes without libjpeg's block smoothing
(which applies only while AC coefficients 1-9 are not yet refined); a
file whose data stops short of that raises. So do arithmetic coding,
lossless and hierarchical files, precisions other than 8 bits, and
2- or 4-component (CMYK/YCCK) images: NotImplementedError names the
reason. Malformed data raises ValueError.

The Huffman decode is a Python loop over symbols (a 16-bit lookup table
per code, a 24-bit window per byte), so it is the slow part: time it on
the host that decodes (PERF.md has a 2048x2048 texture's time). The rest
is vectorised over blocks and pixels.
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

_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG", 0xC5: "hierarchical (differential) JPEG",
    0xC6: "hierarchical (differential) JPEG",
    0xC7: "hierarchical (differential) JPEG",
    0xC9: "arithmetic coding", 0xCA: "arithmetic coding",
    0xCB: "arithmetic coding (lossless)", 0xCD: "arithmetic coding",
    0xCE: "arithmetic coding", 0xCF: "arithmetic coding (lossless)",
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


def _scan(frame, scan_comps, ss, se, ah, al, segs, restart, coefs, luts):
    """Decode one scan into `coefs` (a flat list per component, 64 ints a
    block in natural order, blocks row-major over the padded block grid)."""
    progressive = frame["progressive"]
    if len(scan_comps) == 1:
        c = scan_comps[0]
        bw, bh = c.bw, c.bh  # the real blocks only
        units = [[(c, (by * c.pbw + bx) * 64)] for by in range(bh)
                 for bx in range(bw)]
    else:
        units = []
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                u = []
                for c in scan_comps:
                    for v in range(c.v):
                        for h in range(c.h):
                            blk = ((my * c.v + v) * c.pbw + mx * c.h + h)
                            u.append((c, blk * 64))
                units.append(u)
    per = restart if restart else len(units)
    nseg = (len(units) + per - 1) // per if units else 0
    if len(segs) < nseg:
        segs = segs + [b""] * (nseg - len(segs))
    for si in range(nseg):
        w = _windows(segs[si])
        pos = 0
        pred = {c.id: 0 for c in scan_comps}
        eobrun = 0
        for unit in units[si * per:(si + 1) * per]:
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


def _parse(data: bytes, name: str):
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    qts, luts = {}, ({}, {})
    frame = None
    coefs = {}
    restart = 0
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
        if marker == 0xCC:
            raise NotImplementedError(
                f"{name}: arithmetic coding is not supported")
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nc = struct.unpack_from(">BHHB", body)
            if precision != 8:
                raise NotImplementedError(
                    f"{name}: {precision}-bit samples are not supported "
                    "(8-bit only)")
            if nc == 4:
                raise NotImplementedError(
                    f"{name}: 4-component (CMYK/YCCK) JPEG is not supported")
            if nc not in (1, 3):
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
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError(f"{name}: bad sampling factors")
                c.w = -(-width * c.h // hmax)  # downsampled size
                c.hgt = -(-height * c.v // vmax)
                c.bw, c.bh = -(-c.w // 8), -(-c.hgt // 8)
                c.pbw, c.pbh = mcux * c.h, mcuy * c.v
                if nc == 1:  # one block an MCU
                    c.pbw, c.pbh = c.bw, c.bh
                coefs[c.id] = [0] * (c.pbw * c.pbh * 64)
            if nc == 1:
                mcux, mcuy = comps[0].bw, comps[0].bh
            frame = dict(width=width, height=height, comps=comps,
                         hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy,
                         progressive=marker == 0xC2)
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
            if not frame["progressive"]:
                ss, se, ah, al = 0, 63, 0, 0
            segs, pos = _segments(data, pos)
            for c in scan_comps:
                for k in range(ss, se + 1):
                    coef_bits[c.id][k] = al
            _scan(frame, scan_comps, ss, se, ah, al, segs, restart, coefs,
                  luts)
        # APPn, COM, DNL and the rest: skipped
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    if frame["progressive"]:
        for c in frame["comps"]:
            q = qts.get(c.tq)
            bits = coef_bits[c.id]
            quant_ok = q is not None and all(
                q[NATURAL[k]] for k in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9))
            if quant_ok and bits[0] >= 0 and any(bits[k] for k in
                                                 range(1, 10)):
                raise NotImplementedError(
                    f"{name}: progressive data with AC coefficients 1-9 not "
                    "fully refined (libjpeg block smoothing) is not "
                    "supported")
    if len(frame["comps"]) == 3:
        ids = tuple(c.id for c in frame["comps"])
        if jfif:
            rgb = False
        elif adobe:
            rgb = adobe_transform == 0
        else:
            rgb = ids == (82, 71, 66)
    else:
        rgb = False
    return frame, coefs, qts, rgb


def decode_jpeg(data: bytes, name: str = "JPEG image") -> np.ndarray:
    """uint8 [H, W, 4]: PIL's `convert("RGBA")` of the file (libjpeg-turbo
    default decode), alpha 255."""
    frame, coefs, qts, rgb = _parse(bytes(data), name)
    width, height = frame["width"], frame["height"]
    planes = []
    for c in frame["comps"]:
        if c.tq not in qts:
            raise ValueError(f"{name}: missing quantisation table {c.tq}")
        blocks = np.asarray(coefs[c.id], np.int64).reshape(-1, 64)
        samples = idct_islow(blocks, qts[c.tq])
        plane = samples.reshape(c.pbh, c.pbw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.pbh * 8, c.pbw * 8)[:c.hgt, :c.w]
        fh, fv = frame["hmax"] // c.h, frame["vmax"] // c.v
        if fh * c.h != frame["hmax"] or fv * c.v != frame["vmax"]:
            raise NotImplementedError(
                f"{name}: non-integer sampling ratios are not supported")
        up = _upsample(plane.astype(np.int64), fh, fv)
        planes.append(up[:height, :width])
    out = np.full((height, width, 4), 255, np.uint8)
    if len(planes) == 1:
        out[..., :3] = planes[0][..., None]
    elif rgb:
        out[..., :3] = np.stack(planes, -1)
    else:
        out[..., :3] = np.stack(_ycc_to_rgb(*planes), -1)
    return out


def jpeg_rgba(data: bytes, name: str = "JPEG image") -> np.ndarray:
    """float32 [H, W, 4] in [0, 1]: decode_jpeg / 255, as the JAX package
    turns PIL's RGBA into a texture."""
    return decode_jpeg(data, name).astype(np.float32) / 255.0
