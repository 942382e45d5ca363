"""TensorBoard event files written without TensorFlow (the writer behind
``MetricLogger(tensorboard=True)``; the JAX package's goes through
``tf.summary``).

A file is a sequence of TFRecords: a little-endian u64 payload length, the
masked CRC32C of those 8 bytes, the payload, and the masked CRC32C of the
payload. Each payload is one ``tensorflow.Event`` protocol buffer, encoded
here by hand (the fields below are all the writer needs):

* ``Event``: ``wall_time`` (1, double), ``step`` (2, int64),
  ``file_version`` (3, string), ``summary`` (5, ``Summary``);
* ``Summary``: ``value`` (1, repeated ``Summary.Value``);
* ``Summary.Value``: ``tag`` (1), ``tensor`` (8, ``TensorProto``),
  ``metadata`` (9, ``SummaryMetadata``);
* ``TensorProto``: ``dtype`` (1, DT_FLOAT = 1), ``tensor_shape`` (2, empty
  for a scalar), ``tensor_content`` (4, the little-endian f32 bytes);
* ``SummaryMetadata``: ``plugin_data`` (1, ``PluginData``: ``plugin_name``
  1), ``data_class`` (4, DATA_CLASS_SCALAR = 1).

The first event carries ``file_version "brain.Event:2"``; then every scalar
is one event, as ``tf.summary.scalar`` writes it. A failed write raises.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np

_CRC32C_POLY = 0x82F63B78               # Castagnoli, reflected


def _crc_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: the CRC rotated right by 15 bits plus 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(payload: bytes) -> bytes:
    """One TFRecord holding ``payload``."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # an int64 below 0: two's complement
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _message(field: int, payload: bytes) -> bytes:
    """A length-delimited field: a string, bytes or a nested message."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def scalar_summary(tag: str, value: float) -> bytes:
    """A ``Summary`` of one scalar ``value`` (rounded to f32) under ``tag``,
    with the scalars plugin's metadata."""
    tensor = (_tag(1, 0) + _varint(1)                       # DT_FLOAT
              + _message(2, b"")                            # shape ()
              + _message(4, np.float32(value).tobytes()))   # little-endian
    metadata = (_message(1, _message(1, b"scalars"))
                + _tag(4, 0) + _varint(1))                  # SCALAR
    value_msg = (_message(1, tag.encode()) + _message(8, tensor)
                 + _message(9, metadata))
    return _message(1, value_msg)


def event(wall_time: float, step: int = 0, *,
          file_version: Optional[str] = None,
          summary: Optional[bytes] = None) -> bytes:
    """An ``Event`` with its wall time, its step (omitted at 0, as proto3
    omits a default) and either a file version or a summary."""
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(step)
    if file_version is not None:
        out += _message(3, file_version.encode())
    if summary is not None:
        out += _message(5, summary)
    return out


class EventFileWriter:
    """Scalars into a new ``events.out.tfevents.<time>.<host>.<pid>.<n>.v2``
    file of ``logdir``: ``n`` is the first number no other file of this
    second, host and process has taken."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        stem = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        for n in itertools.count():
            self.path = os.path.join(logdir, f"{stem}.{n}.v2")
            try:
                self._fh = open(self.path, "xb")
                break
            except FileExistsError:
                continue
        self._fh.write(record(event(time.time(),
                                    file_version="brain.Event:2")))
        self._fh.flush()

    def add_scalars(self, step: int, metrics: Dict[str, float]) -> None:
        """One event per metric, in the order given, written through to the
        file."""
        for tag, value in metrics.items():
            self._fh.write(record(event(
                time.time(), int(step),
                summary=scalar_summary(tag, float(value)))))
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
