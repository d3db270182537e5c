"""Dependency-free TFRecord container IO (port of
``gpudrive_lab_tpu/data_utils/tfrecord.py``).

The reference reads WOMD shards with ``tf.data.TFRecordDataset``
(reference: data_utils/process_waymo_files.py, process_tfrecord), pulling in
all of TensorFlow for what is a trivial framing format.  This module
implements that framing directly so the conversion pipeline runs with no
optional dependencies:

    each record:  uint64 length (LE)
                  uint32 masked crc32c of the length bytes (LE)
                  <length> payload bytes
                  uint32 masked crc32c of the payload (LE)

crc32c is the Castagnoli CRC-32 (polynomial 0x1EDC6F41, reflected
0x82F63B78) — NOT zlib.crc32 — with TensorFlow's rotate-and-add masking.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator

_CRC_TABLE = []


def _table() -> list:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def read_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield the raw payload of each record in a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise IOError(f"{path}: length crc mismatch")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(payload) != data_crc:
                raise IOError(f"{path}: payload crc mismatch")
            yield payload


def write_tfrecord(path: str, payloads: Iterable[bytes]) -> int:
    """Write records (used by tests and tooling); returns the count."""
    n = 0
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(p)
            f.write(struct.pack("<I", masked_crc32c(p)))
            n += 1
    return n
