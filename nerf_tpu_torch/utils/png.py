"""PNG encode and decode with the standard library (``zlib``, ``struct``).

Covers 8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA images,
which is what Blender-format scenes and rendered frames use. The encoder
writes every scanline with filter 0; the decoder undoes all five filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}      # color type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8 with C in 1..4 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png wants 1 to 4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)      # filter byte 0 per row
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 1:      # Sub: running sum per channel, mod 256
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            row = row + prev
        elif ftype in (3, 4):   # Average / Paeth: byte-serial
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        elif ftype != 0:
            raise ValueError(f"PNG: bad filter type {ftype} in row {y}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 for grayscale, else (H, W, C)."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: only 8-bit non-interlaced gray/RGB(A) is "
                         f"supported (depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    c = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
