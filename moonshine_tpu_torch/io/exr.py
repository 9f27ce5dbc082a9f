"""OpenEXR scanline codec, pure numpy (a copy of moonshine_tpu/io/exr.py,
so the port reads and writes EXR without importing the JAX package).

Implements the OpenEXR 2.0 single-part scanline format with NONE / RLE /
ZIP / ZIPS / PIZ compression, reading and writing: RLE and PIZ are the
common compressions of published HDRI skyboxes (ImfRle, and ImfPiz's
bitmap/LUT + 2D wavelet + Huffman pipeline from the OpenEXR spec; the
Huffman decoder is a Python bit loop, as in the copied module). Reading
takes a path or the file's bytes; luminance-only (Y) files come back as
grey RGB. `write_exr` writes 3-channel float with ZIP by default, the
offline renderer's output format. B44/DWA and deep, tiled or multi-part
files raise a clear error.

Layout facts used below (OpenEXR file format docs):
  * header = attribute list (name\\0 type\\0 size data), empty name ends it
  * channels are stored alphabetically; scanline chunk = [y:i32, size:i32,
    then per scanline, per channel, a full row]
  * ZIP chunks hold 16 scanlines (ZIPS: 1), zlib-compressed after a
    split-halves byte reorder + delta predictor
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
NO_COMPRESSION, RLE, ZIPS, ZIP, PIZ = 0, 1, 2, 3, 4
_DTYPES = {PT_UINT: np.uint32, PT_HALF: np.float16, PT_FLOAT: np.float32}
_SIZES = {PT_UINT: 4, PT_HALF: 2, PT_FLOAT: 4}


# --- ZIP predictor/reorder (OpenEXR ImfZip) ---

def _zip_postprocess(raw: bytes) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8).astype(np.int32)
    data = np.cumsum(np.concatenate([data[:1], data[1:] - 128]), dtype=np.int64)
    data = (data & 0xFF).astype(np.uint8)
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _zip_preprocess(data: np.ndarray) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    t = tmp.astype(np.int32)
    d = np.empty(n, np.int32)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


# --- RLE (OpenEXR ImfRle + the ZIP-style predictor/reorder) ---

def _rle_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        b = data[i]
        i += 1
        if b > 127:  # signed char < 0: literal run of (256 - b) bytes
            cnt = 256 - b
            out += data[i:i + cnt]
            i += cnt
        else:  # repeat next byte (b + 1) times
            out += data[i:i + 1] * (b + 1)
            i += 1
    return bytes(out)


def _rle_encode(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        run = 1
        while i + run < n and raw[i + run] == raw[i] and run < 127:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(raw[i])
            i += run
        else:
            # literal: extend until a >=3 run starts (or the 127 cap)
            j = i + 1
            while (j < n and j - i < 127
                   and not (j + 2 < n
                            and raw[j] == raw[j + 1] == raw[j + 2])):
                j += 1
            out.append(256 - (j - i))
            out += raw[i:j]
            i = j
    return bytes(out)


# --- PIZ (ImfPizCompressor: bitmap/LUT + 2D wavelet + Huffman) ---
#
# Layout per chunk (32 scanlines): u16 minNonZero, u16 maxNonZero,
# bitmap[max-min+1] bytes, i32 huffLength, huffman bitstream. The pixel
# data inside is PLANE-major (each channel's chunk rows contiguous, as
# arrays of u16; FLOAT/UINT channels count as two u16 components).

_BITMAP_SIZE = 8192  # 65536 values / 8 bits
_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _reverse_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    present = bits.astype(bool)
    present[0] = True  # zero is always representable
    lut = np.nonzero(present)[0].astype(np.uint16)
    max_value = len(lut) - 1
    full = np.zeros(1 << 16, np.uint16)
    full[: len(lut)] = lut
    return full, max_value


def _forward_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    present = bits.astype(bool)
    present[0] = True
    lut = np.zeros(1 << 16, np.uint16)
    idx = np.nonzero(present)[0]
    lut[idx] = np.arange(len(idx), dtype=np.uint16)
    return lut, len(idx) - 1


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (as_ + bs) >> 1
    ds = as_ - bs
    return (ms.astype(np.int16).astype(np.uint16),
            ds.astype(np.int16).astype(np.uint16))


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d = d & _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet decode (ImfWav.cpp wav2Decode), vectorized."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, max(ny - p2 + 1, 0), p2)
        xs = np.arange(0, max(nx - p2 + 1, 0), p2)
        if len(ys) and len(xs):
            i00, i10 = dec(a[np.ix_(ys, xs)], a[np.ix_(ys + p, xs)])
            i01, i11 = dec(a[np.ix_(ys, xs + p)], a[np.ix_(ys + p, xs + p)])
            r00, r01 = dec(i00, i01)
            r10, r11 = dec(i10, i11)
            a[np.ix_(ys, xs)] = r00
            a[np.ix_(ys, xs + p)] = r01
            a[np.ix_(ys + p, xs)] = r10
            a[np.ix_(ys + p, xs + p)] = r11
        if (nx & p) and len(ys):  # border column (vertical pairs)
            xb = len(xs) * p2
            c0, c1 = dec(a[ys, xb], a[ys + p, xb])
            a[ys, xb] = c0
            a[ys + p, xb] = c1
        if (ny & p) and len(xs):  # border row (horizontal pairs)
            yb = len(ys) * p2
            r0, r1 = dec(a[yb, xs], a[yb, xs + p])
            a[yb, xs] = r0
            a[yb, xs + p] = r1
        p2 = p
        p >>= 1


def _wav2_encode(a: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet encode (ImfWav.cpp wav2Encode), vectorized."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ys = np.arange(0, max(ny - p2 + 1, 0), p2)
        xs = np.arange(0, max(nx - p2 + 1, 0), p2)
        if len(ys) and len(xs):
            i00, i01 = enc(a[np.ix_(ys, xs)], a[np.ix_(ys, xs + p)])
            i10, i11 = enc(a[np.ix_(ys + p, xs)], a[np.ix_(ys + p, xs + p)])
            r00, r10 = enc(i00, i10)
            r01, r11 = enc(i01, i11)
            a[np.ix_(ys, xs)] = r00
            a[np.ix_(ys, xs + p)] = r01
            a[np.ix_(ys + p, xs)] = r10
            a[np.ix_(ys + p, xs + p)] = r11
        if (nx & p) and len(ys):
            xb = len(xs) * p2
            c0, c1 = enc(a[ys, xb], a[ys + p, xb])
            a[ys, xb] = c0
            a[ys + p, xb] = c1
        if (ny & p) and len(xs):
            yb = len(ys) * p2
            r0, r1 = enc(a[yb, xs], a[yb, xs + p])
            a[yb, xs] = r0
            a[yb, xs + p] = r1
        p = p2
        p2 <<= 1


# --- Huffman coding (ImfHuf.cpp; canonical codes, 16-bit symbols + one
# run-length escape symbol, 6-bit packed length table) ---

_HUF_ENCSIZE = (1 << 16) + 1
_HUF_DECBITS = 14
_HUF_DECMASK = (1 << _HUF_DECBITS) - 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Code-from-length assignment, exactly hufCanonicalCodeTable."""
    n = np.zeros(59, np.uint64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = np.uint64(0)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> np.uint64(1)
        n[i] = c
        c = nc
    codes = np.zeros(len(lengths), np.uint64)
    for i in np.nonzero(lengths)[0]:
        l = lengths[i]
        codes[i] = n[l]
        n[l] += 1
    return codes


class _HufDecoder:
    def __init__(self, lengths: np.ndarray, codes: np.ndarray):
        self.len14 = np.zeros(1 << _HUF_DECBITS, np.int32)
        self.sym14 = np.zeros(1 << _HUF_DECBITS, np.int64)
        self.longs: dict[int, list] = {}
        for i in np.nonzero(lengths)[0]:
            l = int(lengths[i])
            c = int(codes[i])
            if l > _HUF_DECBITS:
                prefix = c >> (l - _HUF_DECBITS)
                self.longs.setdefault(prefix, []).append((l, c, int(i)))
            else:
                start = c << (_HUF_DECBITS - l)
                span = 1 << (_HUF_DECBITS - l)
                self.len14[start:start + span] = l
                self.sym14[start:start + span] = i

    def decode(self, data: bytes, n_bits: int, rlc: int,
               n_out: int) -> np.ndarray:
        out = np.empty(n_out, np.uint16)
        oi = 0
        c = 0
        lc = 0
        len14 = self.len14
        sym14 = self.sym14
        longs = self.longs
        nbytes = (n_bits + 7) // 8
        i = 0

        def emit(sym):
            nonlocal oi, c, lc, i
            if sym == rlc:  # run: 8-bit count of repeats of previous value
                if lc < 8:
                    raise ValueError("EXR: truncated huffman run")
                cs = (c >> (lc - 8)) & 0xFF
                lc -= 8
                if oi == 0 or oi + cs > n_out:
                    raise ValueError("EXR: bad huffman run")
                out[oi:oi + cs] = out[oi - 1]
                oi += cs
            else:
                out[oi] = sym
                oi += 1
            return lc

        while i < nbytes:
            c = ((c << 8) | data[i]) & ((1 << 64) - 1)
            i += 1
            lc += 8
            while lc >= _HUF_DECBITS:
                idx = (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
                l = int(len14[idx])
                if l:
                    lc -= l
                    sym = int(sym14[idx])
                    if sym == rlc and lc < 8 and i < nbytes:
                        c = (c << 8) | data[i]
                        i += 1
                        lc += 8
                    lc = emit(sym)
                else:
                    # long code: extend until one matches
                    found = False
                    for ll, cc, sym in longs.get(idx, ()):
                        while lc < ll and i < nbytes:
                            c = (c << 8) | data[i]
                            i += 1
                            lc += 8
                        if lc >= ll and (
                            (c >> (lc - ll)) & ((1 << ll) - 1)
                        ) == cc:
                            lc -= ll
                            if sym == rlc and lc < 8 and i < nbytes:
                                c = (c << 8) | data[i]
                                i += 1
                                lc += 8
                            lc = emit(sym)
                            found = True
                            break
                    if not found:
                        raise ValueError("EXR: invalid huffman code")
        # drop the pad bits of the final byte, then drain
        pad = (8 - n_bits) & 7
        c >>= pad
        lc -= pad
        while lc > 0:
            idx = (c << (_HUF_DECBITS - lc)) & _HUF_DECMASK
            l = int(len14[idx])
            if l and l <= lc:
                lc -= l
                lc = emit(int(sym14[idx]))
            else:
                break
        if oi != n_out:
            raise ValueError(f"EXR: huffman decoded {oi} of {n_out}")
        return out


def _huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, table_len, n_bits, _ = struct.unpack_from("<5I", data, 0)
    if iM >= _HUF_ENCSIZE:
        raise ValueError("EXR: bad huffman table range")
    off = 20
    # unpack the 6-bit-packed code-length table (hufUnpackEncTable)
    lengths = np.zeros(_HUF_ENCSIZE, np.int32)
    c = 0
    lc = 0
    i = im
    pos = off
    while i <= iM:
        while lc < 6:
            c = (c << 8) | data[pos]
            pos += 1
            lc += 8
        l = (c >> (lc - 6)) & 0x3F
        lc -= 6
        if l == _LONG_ZEROCODE_RUN:
            while lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            run = ((c >> (lc - 8)) & 0xFF) + _SHORTEST_LONG_RUN
            lc -= 8
            i += run
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    codes = _huf_canonical_codes(lengths)
    dec = _HufDecoder(lengths, codes)
    # the bitstream begins exactly table_len bytes after the header
    return dec.decode(data[20 + table_len:], n_bits, iM, n_out)


def _huf_compress(raw: np.ndarray) -> bytes:
    """Huffman-encode u16 symbols; output layout matches hufCompress. The
    run-length escape is max(symbol)+1 (a dedicated pseudo-symbol, so
    literal data can never alias the escape)."""
    freq = np.bincount(raw, minlength=1)
    max_sym = len(freq) - 1
    rlc = max_sym + 1
    freqs = {int(s): int(freq[s]) for s in np.nonzero(freq)[0]}
    freqs[rlc] = 1
    # build code lengths (heap huffman; depth is far below the 58 cap for
    # 16-bit alphabets in practice)
    import heapq
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freqs.items()))]
    heapq.heapify(heap)
    lengths = np.zeros(_HUF_ENCSIZE, np.int32)
    if len(heap) == 1:
        lengths[next(iter(freqs))] = 1
    else:
        uid = len(heap)
        while len(heap) > 1:
            f1, _, s1 = heapq.heappop(heap)
            f2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                lengths[s] += 1
            heapq.heappush(heap, (f1 + f2, uid, s1 + s2))
            uid += 1
    assert lengths.max() <= 58, "huffman depth cap exceeded"
    im = int(np.nonzero(lengths)[0][0])
    iM = rlc
    codes = _huf_canonical_codes(lengths)

    # pack the code-length table, 6 bits each with zero-run codes
    bits = bytearray()
    c = 0
    lc = 0

    def put(val, n):
        nonlocal c, lc
        c = (c << n) | val
        lc += n
        while lc >= 8:
            bits.append((c >> (lc - 8)) & 0xFF)
            lc -= 8

    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            run = 1
            while i + run <= iM and lengths[i + run] == 0:
                run += 1
            if run >= _SHORTEST_LONG_RUN:
                run = min(run, 255 + _SHORTEST_LONG_RUN)
                put(_LONG_ZEROCODE_RUN, 6)
                put(run - _SHORTEST_LONG_RUN, 8)
                i += run
                continue
            if run >= 2:
                run = min(run, 5)
                put(_SHORT_ZEROCODE_RUN + run - 2, 6)
                i += run
                continue
        put(l, 6)
        i += 1
    if lc:
        bits.append((c << (8 - lc)) & 0xFF)
    table_bytes = bytes(bits)

    # encode the data with runs (sendCode semantics)
    bits = bytearray()
    c = 0
    lc = 0
    n_bits = 0

    def putcode(sym):
        nonlocal n_bits
        l = int(lengths[sym])
        put(int(codes[sym]), l)
        n_bits += l

    def put_run(sym, extra):
        nonlocal n_bits
        l = int(lengths[sym])
        if extra * l > l + int(lengths[rlc]) + 8:
            putcode(sym)
            putcode(rlc)
            put(extra, 8)
            n_bits += 8
        else:
            for _ in range(extra + 1):
                putcode(sym)

    vals = raw.tolist()
    j = 0
    n = len(vals)
    while j < n:
        s = vals[j]
        run = 1
        while j + run < n and vals[j + run] == s and run < 256:
            run += 1
        put_run(s, run - 1)
        j += run
    if lc:
        bits.append((c << (8 - lc)) & 0xFF)
    return (
        struct.pack("<5I", im, iM, len(table_bytes), n_bits, 0)
        + table_bytes
        + bytes(bits)
    )


def _piz_channel_layout(channels, width, n_lines):
    """Per channel: (n_u16_components_per_pixel, plane_u16_count)."""
    layout = []
    for name, ptype, _, _ in channels:
        size = 1 if ptype == PT_HALF else 2
        layout.append((name, ptype, size, width * n_lines * size))
    return layout


def _piz_uncompress(payload: bytes, channels, width: int,
                    n_lines: int) -> bytes:
    min_nz, max_nz = struct.unpack_from("<2H", payload, 0)
    off = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        cnt = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(payload, np.uint8,
                                                  cnt, off)
        off += cnt
    lut, max_value = _reverse_lut_from_bitmap(bitmap)
    (length,) = struct.unpack_from("<i", payload, off)
    off += 4
    layout = _piz_channel_layout(channels, width, n_lines)
    n_u16 = sum(p for _, _, _, p in layout)
    tmp = _huf_uncompress(payload[off:off + length], n_u16)
    # wavelet-decode each channel component, then expand via the lut
    pos = 0
    for name, ptype, size, plane in layout:
        arr = tmp[pos:pos + plane].reshape(n_lines, width * size)
        for j in range(size):
            _wav2_decode(arr[:, j::size], max_value)
        pos += plane
    tmp = lut[tmp]
    # back to scanline-interleaved layout (per line, per channel, one row)
    out = bytearray()
    pos = 0
    planes = []
    for name, ptype, size, plane in layout:
        planes.append(tmp[pos:pos + plane].reshape(n_lines,
                                                   width * size))
        pos += plane
    for line in range(n_lines):
        for pl in planes:
            out += pl[line].tobytes()
    return bytes(out)


def _piz_compress(raw: bytes, channels, width: int, n_lines: int) -> bytes:
    layout = _piz_channel_layout(channels, width, n_lines)
    # scanline-interleaved -> plane-major u16
    planes = [np.empty((n_lines, p // n_lines), np.uint16)
              for _, _, _, p in layout]
    pos = 0
    u8 = np.frombuffer(raw, np.uint8)
    for line in range(n_lines):
        for pi, (_, _, size, plane) in enumerate(layout):
            nbytes = (plane // n_lines) * 2
            planes[pi][line] = u8[pos:pos + nbytes].view(np.uint16)
            pos += nbytes
    tmp = np.concatenate([p.reshape(-1) for p in planes])

    present = np.zeros(1 << 16, bool)
    present[tmp] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    lut, max_value = _forward_lut_from_bitmap(bitmap)
    tmp = lut[tmp]

    pos = 0
    for name, ptype, size, plane in layout:
        arr = tmp[pos:pos + plane].reshape(n_lines, width * size)
        for j in range(size):
            _wav2_encode(arr[:, j::size], max_value)
        pos += plane

    huf = _huf_compress(tmp)
    nz = np.nonzero(bitmap)[0]
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        bm = bitmap[min_nz:max_nz + 1].tobytes()
    else:
        min_nz, max_nz = _BITMAP_SIZE - 1, 0
        bm = b""
    return (
        struct.pack("<2H", min_nz, max_nz) + bm
        + struct.pack("<i", len(huf)) + huf
    )


# --- reading ---

def _read_attr_value(type_: bytes, data: bytes):
    if type_ == b"int":
        return struct.unpack("<i", data)[0]
    if type_ == b"float":
        return struct.unpack("<f", data)[0]
    if type_ == b"box2i":
        return struct.unpack("<4i", data)
    if type_ == b"chlist":
        channels = []
        off = 0
        while data[off] != 0:
            end = data.index(b"\x00", off)
            name = data[off:end].decode("latin-1")
            ptype, xs, ys = struct.unpack_from("<i4xii", data, end + 1)
            channels.append((name, ptype, xs, ys))
            off = end + 1 + 16
        return channels
    if type_ == b"compression" or type_ == b"lineOrder":
        return data[0]
    return data


def read_exr(path_or_bytes) -> np.ndarray:
    """Load an EXR as [H, W, 4] float32 RGBA (alpha=1 when absent), the
    reference's Rgba2D convention (exr.zig:208-229)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    off = 8

    attrs = {}
    while buf[off] != 0:
        end = buf.index(b"\x00", off)
        name = buf[off:end]
        off = end + 1
        end = buf.index(b"\x00", off)
        type_ = buf[off:end]
        off = end + 1
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name.decode()] = _read_attr_value(type_, buf[off : off + size])
        off += size
    off += 1  # header terminator

    channels = attrs["channels"]
    comp = attrs["compression"]
    x_min, y_min, x_max, y_max = attrs["dataWindow"]
    width = x_max - x_min + 1
    height = y_max - y_min + 1

    if comp in (NO_COMPRESSION, ZIPS, RLE):
        lines_per_chunk = 1
    elif comp == ZIP:
        lines_per_chunk = 16
    elif comp == PIZ:
        lines_per_chunk = 32
    else:
        raise ValueError(
            f"unsupported EXR compression {comp} "
            "(NONE/RLE/ZIP/ZIPS/PIZ supported)"
        )

    n_chunks = (height + lines_per_chunk - 1) // lines_per_chunk
    off += 8 * n_chunks  # skip the offset table; chunks follow in order

    row_bytes = sum(_SIZES[c[1]] * width for c in channels)
    planes = {
        c[0]: np.zeros((height, width), np.float32) for c in channels
    }

    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        payload = buf[off : off + size]
        off += size
        n_lines = min(lines_per_chunk, y_max - y + 1)
        expected = row_bytes * n_lines
        if size == expected:
            raw = payload  # stored raw (compressor didn't shrink it)
        elif comp in (ZIP, ZIPS):
            raw = _zip_postprocess(zlib.decompress(payload)).tobytes()
        elif comp == RLE:
            raw = _zip_postprocess(_rle_decode(payload, expected)).tobytes()
        elif comp == PIZ:
            raw = _piz_uncompress(payload, channels, width, n_lines)
        else:
            raw = payload
        pos = 0
        for line in range(n_lines):
            yy = y - y_min + line
            for name, ptype, _, _ in channels:
                nbytes = _SIZES[ptype] * width
                arr = np.frombuffer(raw, _DTYPES[ptype], width, pos)
                planes[name][yy] = arr.astype(np.float32)
                pos += nbytes

    out = np.ones((height, width, 4), np.float32)
    for i, ch in enumerate("RGBA"):
        if ch in planes:
            out[..., i] = planes[ch]
    if "Y" in planes and "R" not in planes:  # luminance-only
        out[..., 0] = out[..., 1] = out[..., 2] = planes["Y"]
    return out


# --- writing ---

def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def write_exr(path, image: np.ndarray, compression: int = ZIP,
              pixel_type: int = PT_FLOAT) -> None:
    """Write [H, W, 3|4] float data as scanline EXR (3-channel float to
    match the reference's output format, exr.zig:137-206)."""
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("image must be [H, W, 3|4]")
    H, W, C = image.shape
    names = ["B", "G", "R"] + (["A"] if C == 4 else [])
    # channel name -> image column, stored alphabetically
    src = {"R": 0, "G": 1, "B": 2, "A": 3}
    names = sorted(names)
    dtype = _DTYPES[pixel_type]

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack(
            "<i4xii", pixel_type, 1, 1
        )
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            _attr("channels", "chlist", chlist),
            _attr("compression", "compression", bytes([compression])),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", b"\x00"),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    lines_per_chunk = {ZIP: 16, PIZ: 32}.get(compression, 1)
    n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk
    channels = [(n, pixel_type, 1, 1) for n in names]

    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lines_per_chunk
        n_lines = min(lines_per_chunk, H - y0)
        rows = []
        for line in range(n_lines):
            for n in names:
                rows.append(
                    np.ascontiguousarray(
                        image[y0 + line, :, src[n]].astype(dtype)
                    ).view(np.uint8)
                )
        raw = np.concatenate(rows)
        if compression in (ZIP, ZIPS):
            payload = zlib.compress(_zip_preprocess(raw), 6)
        elif compression == RLE:
            payload = _rle_encode(_zip_preprocess(raw))
        elif compression == PIZ:
            payload = _piz_compress(raw.tobytes(), channels, W, n_lines)
        else:
            payload = raw.tobytes()
        if len(payload) >= len(raw):
            payload = raw.tobytes()  # stored raw, flagged by its size
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)

    base = 8 + len(header) + 8 * n_chunks
    offsets = []
    pos = base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for c in chunks:
            f.write(c)
