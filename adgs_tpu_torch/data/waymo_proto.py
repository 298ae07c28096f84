"""Minimal protobuf wire-format codec for the Waymo Open Dataset Frame (a
copy of adgs_tpu/data/waymo_proto.py, which the port does not import).

Decodes exactly the fields scripts/convert_waymo.py consumes — no
tensorflow, no waymo-open-dataset SDK. The wire format itself (varints,
tags, length-delimited submessages, fixed32/64, packed/unpacked repeated
scalars) is the fully-specified protobuf encoding; the FIELD NUMBERS below
transcribe the public `waymo_open_dataset/dataset.proto` schema:

    Frame:    1 context, 2 timestamp_micros, 3 pose, 4 images, 5 lasers
    Context:  1 name, 2 camera_calibrations, 3 laser_calibrations
    Transform: 1 transform (repeated double)
    CameraImage: 1 name (enum), 2 image (bytes)
    CameraCalibration: 1 name, 2 intrinsic (repeated double),
                       3 extrinsic, 4 width, 5 height
    LaserCalibration: 1 name, 2 beam_inclinations (repeated double),
                      3 beam_inclination_min, 4 beam_inclination_max,
                      5 extrinsic
    Laser:    1 name (enum), 2 ri_return1, 3 ri_return2
    RangeImage: 1 range_image_compressed (zlib MatrixFloat),
                4 range_image_pose_compressed (zlib MatrixFloat)
    MatrixFloat: 1 data (repeated float), 2 shape
    MatrixShape: 1 dims (repeated int32)
    LaserName:  TOP=1 FRONT=2 SIDE_LEFT=3 SIDE_RIGHT=4 REAR=5
    CameraName: FRONT=1 FRONT_LEFT=2 FRONT_RIGHT=3 SIDE_LEFT=4 SIDE_RIGHT=5

The decoder accepts both packed and unpacked repeated-scalar encodings
(proto2 serializers emit unpacked; packed appears in newer exports). The
encoder half exists for byte-faithful test fixtures and emits the
proto2-style unpacked form by default so tests exercise the same branches
real segments hit; `packed=True` writes MatrixFloat data packed, as the
upstream schema declares it (one field per float is slow to write and to
parse at a real range image's 64 x 2650 x 4 floats).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

LASER_TOP = 1


# --------------------------------------------------------------------------
# wire-level primitives
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


def parse_message(buf: bytes) -> dict[int, list]:
    """Generic wire parse: {field_number: [raw values in order]} where a
    raw value is int (varint), bytes (length-delimited), or a float from
    fixed32/fixed64."""
    fields: dict[int, list] = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            (v,) = struct.unpack_from("<d", buf, i)
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            (v,) = struct.unpack_from("<f", buf, i)
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fnum})")
        fields.setdefault(fnum, []).append(v)
    return fields


def _repeated_scalar(vals: list, fmt: str, itemsize: int) -> np.ndarray:
    """Repeated double/float that may be unpacked (list of scalars) or
    packed (one bytes blob); float64, as the reference's list of Python
    floats."""
    parts: list = []
    run: list = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            if run:
                parts.append(np.asarray(run, np.float64))
                run = []
            k = len(v) // itemsize
            parts.append(np.frombuffer(bytes(v), f"<{fmt}", count=k)
                         .astype(np.float64))
        else:
            run.append(v)
    if run or not parts:
        parts.append(np.asarray(run, np.float64))
    return np.concatenate(parts)


def _doubles(fields, num) -> np.ndarray:
    return _repeated_scalar(fields.get(num, []), "d", 8).astype(np.float64)


def _varints(fields, num) -> list[int]:
    out = []
    for v in fields.get(num, []):
        if isinstance(v, (bytes, bytearray)):
            i = 0
            while i < len(v):
                x, i = _read_varint(bytes(v), i)
                out.append(x)
        else:
            out.append(v)
    return out


# --------------------------------------------------------------------------
# schema layer (decode)
# --------------------------------------------------------------------------

@dataclass
class LaserCalibration:
    name: int
    beam_inclinations: np.ndarray
    beam_inclination_min: float
    beam_inclination_max: float
    extrinsic: np.ndarray          # [4, 4]


@dataclass
class CameraCalibration:
    name: int
    intrinsic: np.ndarray          # [9] f u, f v, c u, c v, k...
    extrinsic: np.ndarray          # [4, 4]
    width: int
    height: int


@dataclass
class CameraImage:
    name: int
    image: bytes


@dataclass
class Laser:
    name: int
    range_image: np.ndarray | None          # [H, W, C] f32
    range_image_pose: np.ndarray | None     # [H, W, 6] f32 (TOP only)


@dataclass
class Frame:
    pose: np.ndarray                         # [4, 4] ego->world
    timestamp_micros: int
    images: list[CameraImage] = field(default_factory=list)
    lasers: list[Laser] = field(default_factory=list)
    camera_calibrations: list[CameraCalibration] = field(default_factory=list)
    laser_calibrations: list[LaserCalibration] = field(default_factory=list)


def _transform(fields, num, default_eye: bool = True) -> np.ndarray:
    sub = fields.get(num)
    if not sub:
        return np.eye(4) if default_eye else None
    t = _doubles(parse_message(sub[0]), 1)
    return t.reshape(4, 4) if t.size == 16 else np.eye(4)


def _matrix_float(blob: bytes) -> np.ndarray:
    f = parse_message(zlib.decompress(blob))
    data = _repeated_scalar(f.get(1, []), "f", 4).astype(np.float32)
    dims = _varints(parse_message(f[2][0]), 1) if 2 in f else [data.size]
    return data.reshape(dims)


def decode_frame(buf: bytes) -> Frame:
    f = parse_message(buf)
    frame = Frame(pose=_transform(f, 3),
                  timestamp_micros=int(_varints(f, 2)[0]) if 2 in f else 0)
    if 1 in f:
        ctx = parse_message(f[1][0])
        for raw in ctx.get(2, []):
            c = parse_message(raw)
            frame.camera_calibrations.append(CameraCalibration(
                name=int(_varints(c, 1)[0]),
                intrinsic=_doubles(c, 2),
                extrinsic=_transform(c, 3),
                width=int(_varints(c, 4)[0]) if 4 in c else 0,
                height=int(_varints(c, 5)[0]) if 5 in c else 0))
        for raw in ctx.get(3, []):
            c = parse_message(raw)
            frame.laser_calibrations.append(LaserCalibration(
                name=int(_varints(c, 1)[0]),
                beam_inclinations=_doubles(c, 2),
                beam_inclination_min=float(c.get(3, [0.0])[0]),
                beam_inclination_max=float(c.get(4, [0.0])[0]),
                extrinsic=_transform(c, 5)))
    for raw in f.get(4, []):
        c = parse_message(raw)
        frame.images.append(CameraImage(
            name=int(_varints(c, 1)[0]),
            image=bytes(c.get(2, [b""])[0])))
    for raw in f.get(5, []):
        c = parse_message(raw)
        ri = pose = None
        if 2 in c:   # ri_return1
            r = parse_message(c[2][0])
            if 1 in r:
                ri = _matrix_float(r[1][0])
            if 4 in r:
                pose = _matrix_float(r[4][0])
        frame.lasers.append(Laser(name=int(_varints(c, 1)[0]),
                                  range_image=ri, range_image_pose=pose))
    return frame


# --------------------------------------------------------------------------
# encoder (fixture builder — proto2-style unpacked repeated scalars
# unless packed=True)
# --------------------------------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _tag(num: int, wt: int) -> bytes:
    return _varint((num << 3) | wt)


def enc_varint(num: int, v: int) -> bytes:
    return _tag(num, 0) + _varint(v)


def enc_double(num: int, v: float) -> bytes:
    return _tag(num, 1) + struct.pack("<d", v)


def enc_float(num: int, v: float) -> bytes:
    return _tag(num, 5) + struct.pack("<f", v)


def enc_bytes(num: int, v: bytes) -> bytes:
    return _tag(num, 2) + _varint(len(v)) + v


def enc_doubles(num: int, vals) -> bytes:
    return b"".join(enc_double(num, float(v)) for v in np.ravel(vals))


def enc_transform(num: int, mat: np.ndarray) -> bytes:
    return enc_bytes(num, enc_doubles(1, np.asarray(mat).reshape(16)))


def enc_matrix_float(arr: np.ndarray, packed: bool = False) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape = b"".join(enc_varint(1, d) for d in arr.shape)
    data = (enc_bytes(1, arr.astype("<f4").tobytes()) if packed else
            b"".join(enc_float(1, v) for v in arr.reshape(-1)))
    return zlib.compress(data + enc_bytes(2, shape))


def encode_frame(pose: np.ndarray, timestamp_micros: int,
                 camera_calibrations: list[dict], laser_calibrations:
                 list[dict], images: list[dict], lasers: list[dict],
                 packed: bool = False) -> bytes:
    """Fixture-side Frame serializer (field dicts mirror the dataclasses;
    lasers: {name, range_image [H,W,C], range_image_pose [H,W,6]|None};
    packed: MatrixFloat data as one packed field)."""
    ctx = b""
    for c in camera_calibrations:
        ctx += enc_bytes(2, (enc_varint(1, c["name"])
                             + enc_doubles(2, c["intrinsic"])
                             + enc_transform(3, c["extrinsic"])
                             + enc_varint(4, c["width"])
                             + enc_varint(5, c["height"])))
    for c in laser_calibrations:
        body = enc_varint(1, c["name"])
        if len(c.get("beam_inclinations", [])):
            body += enc_doubles(2, c["beam_inclinations"])
        body += (enc_double(3, c.get("beam_inclination_min", 0.0))
                 + enc_double(4, c.get("beam_inclination_max", 0.0))
                 + enc_transform(5, c["extrinsic"]))
        ctx += enc_bytes(3, body)

    out = enc_bytes(1, ctx)
    out += enc_varint(2, timestamp_micros)
    out += enc_transform(3, pose)
    for im in images:
        out += enc_bytes(4, enc_varint(1, im["name"])
                         + enc_bytes(2, im["image"]))
    for la in lasers:
        ri = enc_bytes(1, enc_matrix_float(la["range_image"], packed))
        if la.get("range_image_pose") is not None:
            ri += enc_bytes(4, enc_matrix_float(la["range_image_pose"],
                                                packed))
        out += enc_bytes(5, enc_varint(1, la["name"]) + enc_bytes(2, ri))
    return out
