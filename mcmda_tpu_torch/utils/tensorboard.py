"""Minimal TensorBoard event-file writer (copy of
``mcmda_tpu/utils/tensorboard.py``).

Dependency-free: hand-encodes the protobuf wire format for
``Event{wall_time, step, summary{value{tag, simple_value}}}`` and the
TFRecord framing (length + masked crc32c) that TensorBoard expects.  Scalars
only.
"""

from __future__ import annotations

import os
import struct
import time


# ------------------------------------------------------------ crc32c (soft)
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- proto encoding
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1 (string), simple_value=2 (float) }
    v = _bytes_field(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", value)
    return _bytes_field(1, v)  # Summary.value (repeated field 1)


def _event(step: int, scalars: dict, wall: float | None = None) -> bytes:
    # Event{ wall_time=1 (double), step=2 (int64), summary=5 (Summary) }
    body = _tag(1, 1) + struct.pack("<d", wall or time.time())
    body += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    summary = b"".join(_scalar_value(k, float(v)) for k, v in scalars.items())
    body += _bytes_field(5, summary)
    return body


class EventWriter:
    """Writes `events.out.tfevents.*` files readable by TensorBoard."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir,
                            f"events.out.tfevents.{int(time.time())}.mcmda")
        self._fh = open(path, "ab")
        self.path = path
        self._write(_event(0, {}))  # file-version header event is optional

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", _masked_crc(record)))
        self._fh.flush()

    def scalars(self, step: int, values: dict) -> None:
        self._write(_event(step, values))

    def close(self) -> None:
        self._fh.close()
