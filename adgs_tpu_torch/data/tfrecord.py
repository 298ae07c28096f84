"""Standalone TFRecord framing reader/writer (no tensorflow; a copy of
adgs_tpu/data/tfrecord.py, which the port does not import).

The TFRecord on-disk format is fully specified and library-independent
(tensorflow/core/lib/io/record_writer.h):

    uint64 length          (little-endian)
    uint32 masked_crc32c(length bytes)
    bytes  data[length]
    uint32 masked_crc32c(data)

with mask(crc) = ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff and
CRC32C (Castagnoli polynomial 0x1EDC6F41, reflected 0x82F63B78).

Used by scripts/convert_waymo.py to decode Waymo Open Dataset segments
without the tensorflow dependency the reference's converter env carries;
the writer exists so tests can build byte-faithful fixtures that exercise
this exact decode path.

The CRC gives the reference's table-driven value bit for bit, but a Waymo
record holds megabytes, which a byte-at-a-time loop in Python takes
seconds over. Long inputs are therefore cut into equal lanes whose CRC
registers advance together, one numpy step per byte position, and the
lanes are merged with the register's "skip n zero bytes" map, which is
linear over GF(2) (the construction of zlib's crc32_combine).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

_CRC_TABLE: np.ndarray | None = None
_SERIAL_BELOW = 4096      # bytes; shorter inputs run the byte loop


def _table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = np.uint32(0x82F63B78)          # reflected Castagnoli
        t = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            t = np.where(t & 1, (t >> np.uint32(1)) ^ poly,
                         t >> np.uint32(1))
        _CRC_TABLE = t
    return _CRC_TABLE


def _crc_serial(data: bytes) -> int:
    tab = _table().tolist()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_BITS = np.arange(32, dtype=np.uint32)


def _apply(op: np.ndarray, regs: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map on 32-bit registers, given as the images of the
    32 unit vectors, applied to each entry of `regs`."""
    bits = (regs[..., None] >> _BITS) & np.uint32(1)
    return np.bitwise_xor.reduce(np.where(bits.astype(bool), op, 0)
                                 .astype(np.uint32), axis=-1)


def _zeros_op(n: int) -> np.ndarray:
    """The map that n zero bytes apply to a register (by squaring)."""
    one = _table()[(np.uint32(1) << _BITS) & np.uint32(0xFF)] ^ (
        (np.uint32(1) << _BITS) >> np.uint32(8))
    out = np.uint32(1) << _BITS                       # identity
    while n:
        if n & 1:
            out = _apply(one, out)
        one = _apply(one, one)
        n >>= 1
    return out


def _byte_tables(op: np.ndarray) -> np.ndarray:
    """[4, 256] tables: op(x) = T0[x & 255] ^ T1[x >> 8 & 255] ^ ..."""
    b = np.arange(256, dtype=np.uint32)
    return np.stack([_apply(op, b << np.uint32(8 * j)) for j in range(4)])


def _apply_tables(tabs: np.ndarray, regs: np.ndarray) -> np.ndarray:
    out = tabs[0][regs & 0xFF]
    for j in range(1, 4):
        out ^= tabs[j][(regs >> np.uint32(8 * j)) & 0xFF]
    return out


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli), table-driven."""
    n = len(data)
    if n < _SERIAL_BELOW:
        return _crc_serial(data)
    tab = _table()
    lanes = 1 << max(6, int(np.sqrt(n / 4)).bit_length())
    lane_len = -(-n // lanes)
    # leading zero bytes leave a zero register at zero, so the padded
    # input has the same register from zero as the input itself
    buf = np.zeros(lanes * lane_len, np.uint8)
    buf[lanes * lane_len - n:] = np.frombuffer(data, np.uint8)
    cols = buf.reshape(lanes, lane_len).T.astype(np.uint32)
    reg = np.zeros(lanes, np.uint32)
    for col in cols:
        reg = tab[(reg ^ col) & 0xFF] ^ (reg >> np.uint32(8))
    # merge neighbouring lanes: reg(a || b) = skip_len(b)(reg(a)) ^ reg(b)
    op = _zeros_op(lane_len)
    while len(reg) > 1:
        reg = _apply_tables(_byte_tables(op), reg[0::2]) ^ reg[1::2]
        op = _apply(op, op)
    # the register started at 0xFFFFFFFF, not zero
    start = _apply(_zeros_op(n), np.array([0xFFFFFFFF], np.uint32))[0]
    return int(reg[0] ^ start ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield the raw record payloads of a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            if len(hdr) != 8:
                raise IOError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", hdr)
            (lcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(hdr) != lcrc:
                raise IOError(f"{path}: length CRC mismatch")
            data = f.read(length)
            if len(data) != length:
                raise IOError(f"{path}: truncated record")
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(data) != dcrc:
                raise IOError(f"{path}: data CRC mismatch")
            yield data


def write_records(path: str, records: list[bytes]) -> None:
    """Write payloads in the exact TFRecord framing (fixture builder)."""
    with open(path, "wb") as f:
        for data in records:
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", masked_crc32c(hdr)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
