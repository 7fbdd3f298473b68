"""Scalar curves: TensorBoard event files and a CSV mirror (port of
mtt_tpu/utils/tb_writer.py).

The training loop logs every loss, the learning rate and imgs/s at each log
line and the task scores at each eval. The writer needs no TensorBoard
package: it encodes the Event/Summary protobuf wire format and the TFRecord
framing (length + masked CRC32C) that TensorBoard's event loader reads, and
mirrors everything to ``scalars.csv``.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional

# --- CRC32C (Castagnoli), table-driven ------------------------------------

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
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    # Summary { value = 1 (repeated message) }
    summary = _pb_bytes(1, val)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return (_pb_double(1, wall_time) + _pb_int(2, int(step))
            + _pb_bytes(5, summary))


def _file_version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 (string) }
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """add_scalar / flush / close, tensorboard-compatible output plus a
    scalars.csv mirror (step,tag,value,wall_time)."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        name = f"events.out.tfevents.{int(now)}.{host}{suffix}"
        self._f = open(os.path.join(log_dir, name), "ab")
        self._f.write(_tfrecord(_file_version_event(now)))
        self._csv = open(os.path.join(log_dir, "scalars.csv"), "a")
        if self._csv.tell() == 0:
            self._csv.write("step,tag,value,wall_time\n")

    def add_scalar(self, tag: str, value: float, step: int):
        now = time.time()
        self._f.write(_tfrecord(_scalar_event(now, step, tag, value)))
        self._csv.write(f"{int(step)},{tag},{float(value)},{now:.3f}\n")

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            try:
                self.add_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass  # non-scalar entry (nested dict handled by caller)

    def flush(self):
        self._f.flush()
        self._csv.flush()

    def close(self):
        self.flush()
        self._f.close()
        self._csv.close()


def flatten_scores(scores: Dict, prefix: str = "") -> Dict[str, float]:
    """{'semseg': {'mIoU': ..}, 'depth': {...}} -> {'semseg/mIoU': ..}."""
    out = {}
    for k, v in scores.items():
        if isinstance(v, dict):
            out.update(flatten_scores(v, prefix + str(k) + "/"))
        else:
            try:
                out[prefix + str(k)] = float(v)
            except (TypeError, ValueError):
                pass
    return out
