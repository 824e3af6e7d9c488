"""TensorBoard event files written with the standard library and numpy.

The files are those ``torch.utils.tensorboard.SummaryWriter`` writes for the
calls ``nerf_tpu.utils.logging`` makes (scalars, images and the config
text), so TensorBoard reads them as it reads the JAX package's:

  * a file ``events.out.tfevents.{time:010d}.{host}.{pid}.{uid}`` of
    TFRecord records: the length as a little-endian uint64, the masked
    CRC32C of those 8 bytes, the data, the masked CRC32C of the data;
  * each record one ``Event`` protobuf, encoded here by hand (varint,
    fixed32, fixed64 and length-delimited fields; only the fields below);
  * the first event carries ``file_version = "brain.Event:2"``.

Every call is written and flushed before it returns (no thread, no queue);
an I/O error raises.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time

import numpy as np

from nerf_tpu_torch.utils.png import encode_png

# field numbers of tensorboard/compat/proto/{event,summary,tensor,
# tensor_shape}.proto; each message's fields are written in number order, as
# protobuf's own serializer writes them
_EVENT_WALL_TIME, _EVENT_STEP, _EVENT_FILE_VERSION, _EVENT_SUMMARY = 1, 2, 3, 5
_SUMMARY_VALUE = 1
_VALUE_TAG, _VALUE_SIMPLE, _VALUE_IMAGE, _VALUE_TENSOR, _VALUE_METADATA = 1, 2, 4, 8, 9
_IMAGE_HEIGHT, _IMAGE_WIDTH, _IMAGE_COLORSPACE, _IMAGE_ENCODED = 1, 2, 3, 4
_METADATA_PLUGIN_DATA = 1
_PLUGIN_NAME, _PLUGIN_CONTENT = 1, 2
_TENSOR_DTYPE, _TENSOR_SHAPE, _TENSOR_STRING_VAL = 1, 2, 8
_SHAPE_DIM = 2
_DIM_SIZE = 1
DT_STRING = 7

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


def _crc32c_table() -> list:
    poly = 0x82F63B78           # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, a table lookup a byte."""
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's masked CRC."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------------------- protobuf


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF          # negative int64: ten bytes, two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _uint(field: int, n: int) -> bytes:
    return _key(field, _VARINT) + _varint(n) if n else b""     # proto3: 0 is omitted


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, _BYTES) + _varint(len(data)) + data


def _double(field: int, x: float) -> bytes:
    return _key(field, _FIXED64) + struct.pack("<d", x)


def _float(field: int, x: float) -> bytes:
    return _key(field, _FIXED32) + struct.pack("<f", x)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _double(_EVENT_WALL_TIME, wall_time) + _uint(_EVENT_STEP, step) + body


def _summary(value: bytes) -> bytes:
    return _bytes(_EVENT_SUMMARY, _bytes(_SUMMARY_VALUE, value))


def _image_value(tag: str, chw: np.ndarray) -> bytes:
    """A ``Summary.Value`` holding ``chw`` (C, H, W) as a PNG, converted as
    ``torch.utils.tensorboard.summary.image`` converts a float array:
    scaled by 255, clipped to [0, 255] and truncated to uint8."""
    chw = np.asarray(chw)
    if chw.ndim != 3 or chw.shape[0] not in (1, 3, 4):
        raise ValueError(f"add_image wants (C, H, W) with C in 1, 3, 4; got {chw.shape}")
    hwc = chw.transpose(1, 2, 0)
    scale = 1.0 if hwc.dtype == np.uint8 else 255.0
    hwc = (hwc.astype(np.float32) * scale).clip(0, 255).astype(np.uint8)
    h, w, c = hwc.shape
    image = (_uint(_IMAGE_HEIGHT, h) + _uint(_IMAGE_WIDTH, w) + _uint(_IMAGE_COLORSPACE, c)
             + _bytes(_IMAGE_ENCODED, encode_png(hwc)))
    return _bytes(_VALUE_TAG, tag.encode()) + _bytes(_VALUE_IMAGE, image)


def _text_value(tag: str, text: str) -> bytes:
    """A ``Summary.Value`` of the text plugin: tag ``{tag}/text_summary``,
    a DT_STRING tensor of shape [1]."""
    plugin = _bytes(_PLUGIN_NAME, b"text")       # content: TextPluginData(version=0), empty
    metadata = _bytes(_METADATA_PLUGIN_DATA, plugin)
    tensor = (_uint(_TENSOR_DTYPE, DT_STRING)
              + _bytes(_TENSOR_SHAPE, _bytes(_SHAPE_DIM, _uint(_DIM_SIZE, 1)))
              + _bytes(_TENSOR_STRING_VAL, text.encode("utf-8")))
    return (_bytes(_VALUE_TAG, (tag + "/text_summary").encode())
            + _bytes(_VALUE_TENSOR, tensor) + _bytes(_VALUE_METADATA, metadata))


# ---------------------------------------------------------------- writer

_uid = itertools.count()      # torch's writer numbers its files within a process


class EventWriter:
    """An event file in ``log_dir``: ``add_scalar``, ``add_image`` and
    ``add_text`` each write one event and flush it."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%s.%s" % (
            time.time(), socket.gethostname(), os.getpid(), next(_uid))
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), 0, _bytes(_EVENT_FILE_VERSION, b"brain.Event:2")))

    def _write(self, event: bytes) -> None:
        if self._file is None:
            raise ValueError(f"{self.path}: the event writer is closed")
        self._file.write(record(event))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, _summary(
            _bytes(_VALUE_TAG, tag.encode())
            + _float(_VALUE_SIMPLE, float(np.float32(value))))))

    def add_image(self, tag: str, chw: np.ndarray, step: int) -> None:
        self._write(_event(time.time(), step, _summary(_image_value(tag, chw))))

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._write(_event(time.time(), step, _summary(_text_value(tag, text))))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
