"""Animated GIF (GIF89a) encode and decode with the standard library.

The eval CLI's ``--video`` writes its orbit here, beside ``png.py``: every
frame carries its own 256-entry colour table and is LZW-coded (minimum code
size 8, codes up to 12 bits, a clear code when the table fills), after a
NETSCAPE2.0 application extension that loops forever and a graphic control
extension with the frame delay. A frame of at most 256 distinct colours is
stored exactly; a frame of more is quantised uniformly, each channel to the
nearest of evenly spaced levels (8 red, 8 green, 4 blue: 3-3-2 bits), which
``quantize`` states and returns. ``decode_gif`` reads such files back (and
other non-interlaced GIFs: global or local tables, frames drawn over the
previous canvas).
"""

from __future__ import annotations

import struct

import numpy as np

_LEVELS = (8, 8, 4)          # uniform quantisation: levels of red, green, blue


def quantize(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> ``(indices (H, W) uint8, palette (256, 3) uint8)``:
    exact where the frame has at most 256 colours, else each channel to
    its nearest of ``_LEVELS`` evenly spaced values. ``palette[indices]`` is
    the frame as the GIF shows it."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[-1] != 3:
        raise ValueError(f"quantize wants (H, W, 3) uint8, got {frame.dtype} {frame.shape}")
    h, w, _ = frame.shape
    palette = np.zeros((256, 3), np.uint8)
    rgb = frame.reshape(-1, 3).astype(np.int32)
    colors, inverse = np.unique((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2],
                                return_inverse=True)
    if len(colors) <= 256:
        palette[:len(colors)] = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], -1)
        return inverse.reshape(h, w).astype(np.uint8), palette
    idx = np.zeros((h, w), np.int32)
    grids = []
    for c, n in enumerate(_LEVELS):
        q = (frame[..., c].astype(np.int32) * (n - 1) + 127) // 255    # nearest level
        idx = idx * n + q
        grids.append(np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8))
    r, g, b = np.meshgrid(*grids, indexing="ij")
    palette[:] = np.stack([r, g, b], -1).reshape(256, 3)
    return idx.astype(np.uint8), palette


def _lzw_encode(data: bytes, min_size: int = 8) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    width, next_code, table = min_size + 1, eoi + 1, {}

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear)
    prefix = data[0]
    for b in data[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code == 4096:          # table full: clear (at 12 bits)
            emit(clear)
            width, next_code, table = min_size + 1, eoi + 1, {}
        else:
            if next_code >= 1 << width:
                width += 1
            table[key] = next_code
            next_code += 1
        prefix = b
    emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, min_size: int, n: int) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    width, next_code = min_size + 1, eoi + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    prev = None
    acc = nacc = pos = 0
    while len(out) < n:
        while nacc < width:
            if pos >= len(data):
                raise ValueError("GIF: LZW data ends before the image")
            acc |= data[pos] << nacc
            pos += 1
            nacc += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nacc -= width
        if code == clear:
            width, next_code, prev = min_size + 1, eoi + 1, None
            del table[eoi + 1:]
            continue
        if code == eoi:
            break
        if code < next_code:
            entry = table[code]
            add = None if prev is None else table[prev] + entry[:1]
        elif code == next_code and prev is not None:
            entry = add = table[prev] + table[prev][:1]
        else:
            raise ValueError(f"GIF: bad LZW code {code}")
        out += entry
        if add is not None and next_code < 4096:
            table.append(add)
            next_code += 1
            if next_code >= 1 << width and width < 12:
                width += 1
        prev = code
    return bytes(out[:n])


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames, fps: float = 20.0) -> bytes:
    """A sequence of (H, W, 3) uint8 frames of one size -> the bytes of a
    looping GIF89a, each frame shown for ``round(100 / fps)`` hundredths of
    a second (at least 1)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("encode_gif wants at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("encode_gif wants frames of one size")
    delay = max(1, int(round(100.0 / fps)))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        idx, palette = quantize(f)
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, delay, 0) + b"\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + palette.tobytes())
        out.append(b"\x08" + _sub_blocks(_lzw_encode(idx.tobytes())))
    out.append(b"\x3b")
    return b"".join(out)


def _read_sub_blocks(buf: bytes, pos: int) -> tuple[bytes, int]:
    parts = []
    while True:
        n = buf[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(buf[pos:pos + n])
        pos += n


def decode_gif(buf: bytes) -> list[np.ndarray]:
    """GIF bytes -> the list of (H, W, 3) uint8 frames as shown."""
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, flags, _, _ = struct.unpack("<HHBBB", buf[6:13])
    pos, gct = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        gct = np.frombuffer(buf, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    canvas = np.zeros((h, w, 3), np.uint8)
    frames = []
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        if tag == 0x3B:                  # trailer
            break
        if tag == 0x21:                  # extension: skip its sub-blocks
            _, pos = _read_sub_blocks(buf, pos + 1)
            continue
        if tag != 0x2C:
            raise ValueError(f"GIF: bad block 0x{tag:02x} at byte {pos - 1}")
        x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", buf[pos:pos + 9])
        pos += 9
        table = gct
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            table = np.frombuffer(buf, np.uint8, n, pos).reshape(-1, 3)
            pos += n
        if fflags & 0x40:
            raise ValueError("GIF: interlaced frames are not supported")
        if table is None:
            raise ValueError("GIF: a frame without a colour table")
        min_size = buf[pos]
        data, pos = _read_sub_blocks(buf, pos + 1)
        idx = np.frombuffer(_lzw_decode(data, min_size, fw * fh), np.uint8)
        canvas[y0:y0 + fh, x0:x0 + fw] = table[idx].reshape(fh, fw, 3)
        frames.append(canvas.copy())
    return frames


def write_gif(path: str, frames, fps: float = 20.0) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps))


def read_gif(path: str) -> list[np.ndarray]:
    with open(path, "rb") as f:
        return decode_gif(f.read())
