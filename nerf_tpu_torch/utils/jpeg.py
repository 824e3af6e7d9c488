"""JPEG decode with numpy and the standard library, beside ``png.py``.

Decodes what cameras and capture tools write: baseline and extended
sequential Huffman JPEGs (SOF0, SOF1) and progressive ones (SOF2), 8-bit,
with one (grayscale) or three components, sampling factors of 1 or 2 on
each axis (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals (DRI, RST0-7),
8- and 16-bit quantisation tables; APPn and COM segments are skipped, so
an EXIF orientation is ignored, as ``imageio.v2.imread`` ignores it. The
output is the default decode of libjpeg-turbo (what imageio gives through
PIL), in the same integer arithmetic:

  * the islow integer IDCT (libjpeg's ``jidctint.c``) and its range limit;
  * fancy, triangular chroma upsampling (``jdsample.c``'s
    ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample`` and
    ``h2v2_fancy_upsample``, with their rounding biases; a box where the
    chroma is at most 2 samples wide);
  * the fixed-point YCbCr -> RGB of ``jdcolor.c``.

Entropy decoding runs in Python on a 16-bit lookup table a Huffman table;
dequantisation, the IDCT, upsampling and colour conversion run over all
blocks at once in numpy integer arithmetic, so the output is the same bits
on any machine. Arithmetic coding, lossless and hierarchical frames, 12-bit
samples, 4-component (CMYK / YCCK) images and sampling factors above 2
raise ``NotImplementedError`` naming the marker or the field.
"""

from __future__ import annotations

import re

import numpy as np

# zigzag position -> natural (row-major) index, padded as libjpeg pads it so
# that a corrupt run past 63 lands on 63
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_SOF_NAMES = {
    0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)", 0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
    0xCC: "DAC (arithmetic coding conditioning)", 0xDC: "DNL (number of lines)",
    0xDE: "DHP (hierarchical progression)", 0xDF: "EXP (expand reference)",
}

# a marker that ends entropy-coded data: 0xFF not followed by a stuffed 0
# or a restart marker
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")

# value of ``raw`` read as an ``s``-bit magnitude category (JPEG's EXTEND)
_EXTEND = [[0]] + [[r - (1 << s) + 1 if r < 1 << (s - 1) else r for r in range(1 << s)]
                   for s in range(1, 16)]


def _huffman_lut(counts: bytes, symbols: bytes) -> list:
    """A 65,536-entry table: the next 16 bits -> (symbol << 5) | code length;
    0 where no code starts."""
    lut = [0] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            start = code << (16 - length)
            if start + span > 65536:
                raise ValueError("JPEG: bad Huffman table")
            lut[start:start + span] = [(symbols[k] << 5) | length] * span
            code += 1
            k += 1
        code <<= 1
    return lut


class _Bits:
    """MSB-first bits of one restart interval's unstuffed entropy data."""

    def __init__(self, data: bytes) -> None:
        self.data = data + b"\x00" * 16
        self.pos = 0
        self.acc = 0
        self.n = 0

    def _fill(self) -> None:
        self.acc = ((self.acc & ((1 << self.n) - 1)) << 32) | int.from_bytes(
            self.data[self.pos:self.pos + 4], "big")
        self.pos += 4
        self.n += 32

    def bits(self, s: int) -> int:
        if self.n < s:
            self._fill()
        self.n -= s
        return (self.acc >> self.n) & ((1 << s) - 1)

    def symbol(self, lut: list) -> int:
        if self.n < 16:
            self._fill()
        e = lut[(self.acc >> (self.n - 16)) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: bad Huffman code")
        self.n -= e & 31
        return e >> 5

    def extended(self, s: int) -> int:
        return _EXTEND[s][self.bits(s)] if s else 0


def _sequential(data: bytes, blocks: list, pred: list) -> None:
    """Baseline / extended Huffman decode of one restart interval:
    ``blocks`` is [(dc lut, ac lut, coefficient list, offset, component)],
    ``pred`` the DC predictors (reset by the caller)."""
    data += b"\x00" * 16
    zz, ext = _ZIGZAG, _EXTEND
    acc = nbits = pos = 0
    for dc_lut, ac_lut, coefs, off, c in blocks:
        if nbits < 32:
            acc = ((acc & ((1 << nbits) - 1)) << 32) | int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
            nbits += 32
        e = dc_lut[(acc >> (nbits - 16)) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: bad Huffman code")
        nbits -= e & 31
        s = e >> 5
        if s:
            nbits -= s
            pred[c] += ext[s][(acc >> nbits) & ((1 << s) - 1)]
        coefs[off] = pred[c]
        k = 1
        while k < 64:
            if nbits < 32:
                acc = ((acc & ((1 << nbits) - 1)) << 32) | int.from_bytes(
                    data[pos:pos + 4], "big")
                pos += 4
                nbits += 32
            e = ac_lut[(acc >> (nbits - 16)) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            nbits -= e & 31
            rs = e >> 5
            s = rs & 15
            if s:
                k += rs >> 4
                nbits -= s
                coefs[off + zz[k]] = ext[s][(acc >> nbits) & ((1 << s) - 1)]
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _progressive_dc(bits: _Bits, blocks: list, pred: list, al: int, refine: bool) -> None:
    for dc_lut, _, coefs, off, c in blocks:
        if refine:
            if bits.bits(1):
                coefs[off] |= 1 << al
        else:
            pred[c] += bits.extended(bits.symbol(dc_lut))
            coefs[off] = pred[c] << al


def _progressive_ac_first(bits: _Bits, blocks: list, ss: int, se: int, al: int) -> None:
    zz = _ZIGZAG
    eobrun = 0
    for _, ac_lut, coefs, off, _ in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            rs = bits.symbol(ac_lut)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                coefs[off + zz[k]] = bits.extended(s) << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = (1 << r) - 1 + (bits.bits(r) if r else 0)
                break


def _progressive_ac_refine(bits: _Bits, blocks: list, ss: int, se: int, al: int) -> None:
    """Successive approximation of an AC band (libjpeg's
    ``decode_mcu_AC_refine``)."""
    zz = _ZIGZAG
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for _, ac_lut, coefs, off, _ in blocks:
        k = ss
        if not eobrun:
            while k <= se:
                rs = bits.symbol(ac_lut)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.bits(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (bits.bits(r) if r else 0)
                    break
                while k <= se:
                    i = off + zz[k]
                    if coefs[i]:
                        if bits.bits(1) and not coefs[i] & p1:
                            coefs[i] += p1 if coefs[i] >= 0 else m1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coefs[off + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = off + zz[k]
                if coefs[i] and bits.bits(1) and not coefs[i] & p1:
                    coefs[i] += p1 if coefs[i] >= 0 else m1
                k += 1
            eobrun -= 1


# ---------------------------------------------------------------- IDCT

_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: v for name, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}
# post-IDCT range limit, indexed by the descaled value & 1023 (jdmaster.c's
# prepare_range_limit_table): x + 128 clamped to [0, 255] for x in
# [-512, 511], wrapping beyond
_IDCT_LIMIT = np.clip(np.where(np.arange(1024) < 512, np.arange(1024),
                               np.arange(1024) - 1024) + 128, 0, 255).astype(np.uint8)


def _idct_1d(x: list, shift: int) -> list:
    """One pass of jidctint.c over eight int64 arrays (frequency 0..7):
    the eight outputs before their descale by ``shift`` (rounded)."""
    f = _F
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 + z3 * -f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f["1_175875602"]
    tmp0 = tmp0 * f["0_298631336"]
    tmp1 = tmp1 * f["2_053119869"]
    tmp2 = tmp2 * f["3_072711026"]
    tmp3 = tmp3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    r = 1 << (shift - 1)
    return [(v + r) >> shift for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients in natural order and the (64,)
    quantisation table -> (N, 8, 8) uint8 samples, as libjpeg's
    ``jpeg_idct_islow``."""
    d = (coefs.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)   # [n, v, u]
    ws = _idct_1d([d[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)  # columns
    ws = np.stack(ws, axis=1)                                             # [n, y, u]
    out = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _IDCT_LIMIT[np.stack(out, axis=2) & 1023]                      # [n, y, x]


# ---------------------------------------------------------------- upsampling


def _edge(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``x`` shifted by one along ``axis`` (step -1: each element's
    predecessor, +1: its successor), the edge element repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """A chroma plane (its real samples only) upsampled by ``hr`` x ``vr``
    (each 1 or 2) as libjpeg-turbo's fancy upsampling."""
    x = plane.astype(np.int32)
    w = x.shape[1]
    if hr == 2 and w <= 2:            # jinit_upsampler: no fancy filter this narrow
        x = np.repeat(x, 2, axis=1)
        return np.repeat(x, 2, axis=0) if vr == 2 else x
    if hr == 2 and vr == 1:           # h2v1: 3/4 nearer + 1/4 further, biases 1 and 2
        t = 3 * x
        return _interleave((t + _edge(x, 1, -1) + 1) >> 2,
                           (t + _edge(x, 1, 1) + 2) >> 2, 1)
    if hr == 1 and vr == 2:           # h1v2: the same down the columns
        t = 3 * x
        return _interleave((t + _edge(x, 0, -1) + 1) >> 2,
                           (t + _edge(x, 0, 1) + 2) >> 2, 0)
    if hr == 2 and vr == 2:           # h2v2: column sums, then across, biases 8 and 7
        t = 3 * x
        rows = []
        for cs in (t + _edge(x, 0, -1), t + _edge(x, 0, 1)):
            c3 = 3 * cs
            rows.append(_interleave((c3 + _edge(cs, 1, -1) + 8) >> 4,
                                    (c3 + _edge(cs, 1, 1) + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return x


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed point, tables folded in."""
    one_half = 1 << 15
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((91881 * cr + one_half) >> 16)                       # FIX(1.40200)
    g = y + ((-22554 * cb + one_half - 46802 * cr) >> 16)         # FIX(0.34414), FIX(0.71414)
    b = y + ((116130 * cb + one_half) >> 16)                      # FIX(1.77200)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- decoder


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int) -> None:
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None          # latched at the component's first scan, as libjpeg does


def _u16(buf: bytes, pos: int) -> int:
    return (buf[pos] << 8) | buf[pos + 1]


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, or (H, W) for a grayscale JPEG."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qts: dict = {}
    huff: dict = {}
    comps: list = []
    frame = None
    progressive = False
    restart = 0
    adobe_transform = None
    jfif = False
    coefs: list = []
    pos = 2
    while True:
        while pos < len(buf) and buf[pos] != 0xFF:     # garbage before a marker
            pos += 1
        while pos < len(buf) and buf[pos] == 0xFF:     # fill bytes
            pos += 1
        if pos >= len(buf):
            raise ValueError("JPEG: no EOI marker")
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:                              # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:    # stray RSTn / TEM
            continue
        length = _u16(buf, pos)
        seg = buf[pos + 2:pos + length]
        pos += length
        if marker in _SOF_NAMES:
            raise NotImplementedError(f"JPEG marker {_SOF_NAMES[marker]} is not supported")
        if marker in (0xC0, 0xC1, 0xC2):                # SOF0, SOF1, SOF2
            precision, h, w, n = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            name = f"SOF{marker - 0xC0}"
            if precision != 8:
                raise NotImplementedError(f"JPEG {name}: {precision}-bit samples "
                                          "are not supported (8-bit only)")
            if n not in (1, 3):
                raise NotImplementedError(f"JPEG {name}: {n} components (CMYK / YCCK) "
                                          "are not supported (1 or 3)")
            if h == 0:
                raise NotImplementedError(f"JPEG {name}: height 0 (set by a DNL "
                                          "marker) is not supported")
            for i in range(n):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                if not (1 <= hv >> 4 <= 2 and 1 <= hv & 15 <= 2):
                    raise NotImplementedError(
                        f"JPEG {name}: sampling factors {hv >> 4}x{hv & 15} are not "
                        "supported (1 or 2 on each axis)")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v             # padded block grid
                c.cw, c.ch = -(-w * c.h // hmax), -(-h * c.v // vmax)   # real samples
                coefs.append([0] * (c.bw * c.bh * 64))
            frame = (h, w, hmax, vmax, mcux, mcuy)
            progressive = marker == 0xC2
        elif marker == 0xC4:                            # DHT
            i = 0
            while i < len(seg):
                tc_th, counts = seg[i], seg[i + 1:i + 17]
                total = sum(counts)
                huff[(tc_th >> 4, tc_th & 15)] = _huffman_lut(
                    counts, seg[i + 17:i + 17 + total])
                i += 17 + total
        elif marker == 0xDB:                            # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[_ZIGZAG[:64]] = raw
                qts[tq] = qt
                i += 1 + size
        elif marker == 0xDD:                            # DRI
            restart = _u16(seg, 0)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xDA:                            # SOS
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next(j for j, c in enumerate(comps) if c.id == cid)
                scan.append((ci, t >> 4, t & 15))
            ss, se, ah_al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            m = _SCAN_END.search(buf, pos)
            end = m.start() if m else len(buf)
            _decode_scan(buf[pos:end], frame, comps, coefs, scan, huff, qts, restart,
                         progressive, ss, se, ah_al >> 4, ah_al & 15)
            pos = end
        # APPn, COM and anything else: skipped
    if frame is None:
        raise ValueError("JPEG: no frame header")
    h, w, hmax, vmax, _, _ = frame
    planes = []
    for c, cf in zip(comps, coefs):
        if c.qt is None:
            raise ValueError(f"JPEG: component {c.id} is in no scan")
        px = idct_islow(np.array(cf, np.int64).reshape(-1, 64), c.qt)
        px = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        plane = upsample(px[:c.ch, :c.cw], hmax // c.h, vmax // c.v)
        planes.append(plane[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c.id for c in comps)
    rgb = (not jfif and adobe_transform == 0) or (
        not jfif and adobe_transform is None and ids == (82, 71, 66))    # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def _decode_scan(data: bytes, frame: tuple, comps: list, coefs: list, scan: list,
                 huff: dict, qts: dict, restart: int, progressive: bool,
                 ss: int, se: int, ah: int, al: int) -> None:
    mcux, mcuy = frame[4:]
    for ci, _, _ in scan:
        c = comps[ci]
        if c.qt is None:
            if c.tq not in qts:
                raise ValueError(f"JPEG: quantisation table {c.tq} is not defined")
            c.qt = qts[c.tq].copy()
    dc_needed = not progressive or (ss == 0 and ah == 0)
    ac_needed = not progressive or ss > 0

    def lut(kind: int, t: int) -> list | None:
        needed = dc_needed if kind == 0 else ac_needed
        if not needed:
            return None
        if (kind, t) not in huff:
            raise ValueError(f"JPEG: Huffman table {'DC' if kind == 0 else 'AC'} {t} "
                             "is not defined")
        return huff[(kind, t)]

    # the scan's MCUs, each a list of (dc lut, ac lut, coefficients, offset,
    # the component's place in the scan)
    mcus = []
    if len(scan) == 1:                       # non-interleaved: a block an MCU
        ci, td, ta = scan[0]
        c = comps[ci]
        dc, ac = lut(0, td), lut(1, ta)
        for by in range(-(-c.ch // 8)):
            for bx in range(-(-c.cw // 8)):
                mcus.append([(dc, ac, coefs[ci], (by * c.bw + bx) * 64, 0)])
    else:
        parts = [(comps[ci], coefs[ci], lut(0, td), lut(1, ta), j)
                 for j, (ci, td, ta) in enumerate(scan)]
        for my in range(mcuy):
            for mx in range(mcux):
                mcus.append([(dc, ac, cf, ((my * c.v + by) * c.bw + mx * c.h + bx) * 64, j)
                             for c, cf, dc, ac, j in parts
                             for by in range(c.v) for bx in range(c.h)])
    segments = _RESTART.split(data) if restart else [data]
    per = restart if restart else len(mcus)
    for i, seg in enumerate(segments):
        blocks = [b for mcu in mcus[i * per:(i + 1) * per] for b in mcu]
        if not blocks:
            break
        seg = seg.replace(b"\xff\x00", b"\xff")
        pred = [0] * len(scan)
        if not progressive:
            _sequential(seg, blocks, pred)
        elif ss == 0:
            _progressive_dc(_Bits(seg), blocks, pred, al, refine=ah > 0)
        elif ah == 0:
            _progressive_ac_first(_Bits(seg), blocks, ss, se, al)
        else:
            _progressive_ac_refine(_Bits(seg), blocks, ss, se, al)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
