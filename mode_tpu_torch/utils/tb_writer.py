"""A TensorBoard scalar writer on the standard library alone
(``mode_tpu/utils/tb_writer.py``, copied: the port imports nothing of the
JAX package).

The reference logs scalars through tensorboardX / torch's SummaryWriter
(its ``train_disparity.py:20,202-203`` and ``train_fusion.py:19,162``).
This writer produces real TensorBoard event files (TFRecord-framed Event
protos with masked CRC32C): scalars are the only summary kind MODE logs.
``purge_step`` is honoured as TensorBoard honours it, by a session-start
event whose step tells the reader to drop stale data from later steps
(the reference's ``train_fusion.py:162``).
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc32c_table():
  global _CRC_TABLE
  if _CRC_TABLE:
    return _CRC_TABLE
  poly = 0x82F63B78
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ poly if c & 1 else c >> 1
    table.append(c)
  _CRC_TABLE = table
  return table


def _crc32c(data: bytes) -> int:
  table = _crc32c_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  crc = _crc32c(data)
  return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _varint(n: int) -> bytes:
  out = b""
  while True:
    b = n & 0x7F
    n >>= 7
    if n:
      out += bytes([b | 0x80])
    else:
      return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
  return _varint((num << 3) | wire)


def _double_field(num: int, v: float) -> bytes:
  return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
  return _field(num, 5) + struct.pack("<f", v)


def _int_field(num: int, v: int) -> bytes:
  return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(num: int, v: bytes) -> bytes:
  return _field(num, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int, **kw) -> bytes:
  # Event proto: wall_time=1(double), step=2(int64), file_version=3(string),
  # summary=5(message)
  msg = _double_field(1, wall_time) + _int_field(2, step)
  if "file_version" in kw:
    msg += _bytes_field(3, kw["file_version"].encode())
  if "summary" in kw:
    msg += _bytes_field(5, kw["summary"])
  return msg


def _scalar_summary(tag: str, value: float) -> bytes:
  # Summary.Value: tag=1(string), simple_value=2(float); Summary: value=1
  val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
  return _bytes_field(1, val)


class SummaryWriter:
  """Scalar-only TensorBoard writer, torch-compatible call surface."""

  def __init__(self, log_dir: str, purge_step: int | None = None):
    os.makedirs(log_dir, exist_ok=True)
    fname = (f"events.out.tfevents.{int(time.time())}."
             f"{socket.gethostname()}.{os.getpid()}.0")
    self._f = open(os.path.join(log_dir, fname), "ab")
    self._write(_event(time.time(), purge_step or 0,
                       file_version="brain.Event:2"))

  def _write(self, record: bytes):
    header = struct.pack("<Q", len(record))
    self._f.write(header)
    self._f.write(struct.pack("<I", _masked_crc(header)))
    self._f.write(record)
    self._f.write(struct.pack("<I", _masked_crc(record)))
    self._f.flush()

  def add_scalar(self, tag: str, value, step: int):
    self._write(_event(time.time(), int(step),
                       summary=_scalar_summary(tag, float(value))))

  def close(self):
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def _fields(msg: bytes):
  """The (field number, value) pairs of a protobuf message: varints as
  ints, fixed64 as a double, fixed32 as a float, the rest as bytes."""
  i = 0
  while i < len(msg):
    key, i = _read_varint(msg, i)
    num, wire = key >> 3, key & 7
    if wire == 0:
      value, i = _read_varint(msg, i)
    elif wire == 1:
      value, i = struct.unpack_from("<d", msg, i)[0], i + 8
    elif wire == 5:
      value, i = struct.unpack_from("<f", msg, i)[0], i + 4
    elif wire == 2:
      n, i = _read_varint(msg, i)
      value, i = msg[i:i + n], i + n
    else:
      raise ValueError(f"protobuf wire type {wire} is not written here")
    yield num, value


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
  shift = value = 0
  while True:
    b = buf[i]
    i += 1
    value |= (b & 0x7F) << shift
    shift += 7
    if not b & 0x80:
      return value, i


def read_scalars(path: str) -> list[tuple[str, int, float]]:
  """The ``(tag, step, value)`` of every scalar in an event file, in the
  order written; raises on a record whose length or CRC is wrong."""
  with open(path, "rb") as f:
    buf = f.read()
  out, i = [], 0
  while i < len(buf):
    header = buf[i:i + 8]
    (n,) = struct.unpack("<Q", header)
    (crc,) = struct.unpack_from("<I", buf, i + 8)
    record = buf[i + 12:i + 12 + n]
    (record_crc,) = struct.unpack_from("<I", buf, i + 12 + n)
    if crc != _masked_crc(header) or record_crc != _masked_crc(record):
      raise IOError(f"corrupt event record at byte {i} of {path}")
    i += 16 + n
    event = dict(_fields(record))
    for num, value in _fields(event.get(5, b"")):
      if num == 1:
        v = dict(_fields(value))
        out.append((v[1].decode(), event.get(2, 0), v[2]))
  return out
