"""The port's standalone Waymo decode path (adgs_tpu_torch/data/tfrecord.py,
data/waymo_proto.py, scripts/convert_waymo.py) against the JAX package's
(adgs_tpu/data/tfrecord.py, adgs_tpu/data/waymo_proto.py,
scripts/convert_waymo.py) on the CPU.

Tolerances: host bytes (CRCs, record payloads, encoded frames, every
decoded field) bitwise; the converter's files as
tests/test_torch_prep_compare.py's
compare_scene_dirs holds them (cameras.npz, depth maps,
ids and times bitwise, xyz within one float32 ulp at the point's
magnitude)."""

import os
import struct

import numpy as np
import pytest

from adgs_tpu.data import tfrecord as jrec
from adgs_tpu.data import waymo_proto as jwp
from adgs_tpu_torch.data import tfrecord as trec
from adgs_tpu_torch.data import waymo_proto as twp
from adgs_tpu_torch.scripts import convert_waymo as t_waymo
from tests.test_torch_prep_compare import (
    assert_bitwise, compare_scene_dirs, run_jax_script)
from tests.test_waymo_decode import make_waymo_segment


def test_crc32c_known_vectors():
    # RFC 3720 appendix B.4 test vectors
    assert trec.crc32c(b"") == 0
    assert trec.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert trec.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert trec.crc32c(bytes(range(32))) == 0x46DD794E


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 65537, 200_003])
def test_crc32c_matches_jax(rng, n):
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert trec.crc32c(data) == jrec.crc32c(data)
    assert trec.masked_crc32c(data) == jrec.masked_crc32c(data)


def test_record_roundtrip_and_bytes(tmp_path):
    recs = [b"hello", b"", os.urandom(1000), os.urandom(70_000)]
    p, q = str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")
    trec.write_records(p, recs)
    jrec.write_records(q, recs)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert list(trec.read_records(q)) == recs


def test_corruption_detected(tmp_path):
    p = str(tmp_path / "x.tfrecord")
    trec.write_records(p, [b"payload-bytes" * 400])
    raw = bytearray(open(p, "rb").read())
    raw[14] ^= 0xFF   # flip a payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        list(trec.read_records(p))
    raw[14] ^= 0xFF
    raw[3] ^= 0x01    # the length header
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="length CRC"):
        list(trec.read_records(p))


def _frame_kwargs(rng):
    pose = np.eye(4)
    pose[:3, 3] = [1.0, 2.0, 3.0]
    return dict(
        pose=pose, timestamp_micros=123456789,
        camera_calibrations=[dict(
            name=1, intrinsic=np.arange(9, dtype=np.float64) + 0.5,
            extrinsic=rng.normal(size=(4, 4)), width=64, height=48)],
        laser_calibrations=[
            dict(name=jwp.LASER_TOP,
                 beam_inclinations=np.array([-0.3, -0.1, 0.1, 0.3]),
                 beam_inclination_min=-0.3, beam_inclination_max=0.3,
                 extrinsic=rng.normal(size=(4, 4))),
            dict(name=2, beam_inclination_min=-0.2,
                 beam_inclination_max=0.1, extrinsic=np.eye(4))],
        images=[dict(name=1, image=b"\xff\xd8jpegish")],
        lasers=[dict(name=jwp.LASER_TOP,
                     range_image=rng.uniform(0, 10, (4, 8, 4)).astype(
                         np.float32),
                     range_image_pose=rng.normal(size=(4, 8, 6)).astype(
                         np.float32)),
                dict(name=2, range_image=rng.uniform(0, 5, (3, 5, 2)).astype(
                    np.float32))])


def _assert_frames_equal(got, want):
    assert_bitwise(got.pose, want.pose, "pose")
    assert got.timestamp_micros == want.timestamp_micros
    assert len(got.camera_calibrations) == len(want.camera_calibrations)
    for a, b in zip(got.camera_calibrations, want.camera_calibrations):
        assert (a.name, a.width, a.height) == (b.name, b.width, b.height)
        assert_bitwise(a.intrinsic, b.intrinsic, "intrinsic")
        assert_bitwise(a.extrinsic, b.extrinsic, "camera extrinsic")
    assert len(got.laser_calibrations) == len(want.laser_calibrations)
    for a, b in zip(got.laser_calibrations, want.laser_calibrations):
        assert a.name == b.name
        assert_bitwise(a.beam_inclinations, b.beam_inclinations, "beams")
        assert a.beam_inclination_min == b.beam_inclination_min
        assert a.beam_inclination_max == b.beam_inclination_max
        assert_bitwise(a.extrinsic, b.extrinsic, "laser extrinsic")
    assert [(i.name, i.image) for i in got.images] == [
        (i.name, i.image) for i in want.images]
    assert len(got.lasers) == len(want.lasers)
    for a, b in zip(got.lasers, want.lasers):
        assert a.name == b.name
        for k in ("range_image", "range_image_pose"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if y is not None:
                assert_bitwise(x, y, k)


def test_unpacked_encoding_is_jax_bytes(rng):
    kw = _frame_kwargs(rng)
    assert twp.encode_frame(**kw) == jwp.encode_frame(**kw)


@pytest.mark.parametrize("packed", [False, True])
def test_decode_frame_field_by_field(rng, packed):
    kw = _frame_kwargs(rng)
    buf = (twp.encode_frame(**kw, packed=True) if packed
           else jwp.encode_frame(**kw))
    got, want = twp.decode_frame(buf), jwp.decode_frame(buf)
    _assert_frames_equal(got, want)
    assert_bitwise(got.lasers[0].range_image,
                   kw["lasers"][0]["range_image"], "round trip")


def test_repeated_scalars_packed_unpacked_mixed():
    vals = [1.5, -2.25, 3.0, 1e-300]
    packed = b"".join(struct.pack("<d", v) for v in vals)
    buf = (jwp.enc_double(1, 7.0) + jwp.enc_bytes(1, packed)
           + jwp.enc_double(1, -0.5) + jwp.enc_bytes(1, packed))
    fields = jwp.parse_message(buf)
    assert_bitwise(twp._repeated_scalar(fields[1], "d", 8),
                   jwp._repeated_scalar(fields[1], "d", 8), "doubles")
    f32 = np.float32([0.1, -3.7, 1e30])
    buf = jwp.enc_bytes(1, f32.tobytes()) + jwp.enc_float(1, 2.5)
    fields = jwp.parse_message(buf)
    assert_bitwise(twp._repeated_scalar(fields[1], "f", 4),
                   jwp._repeated_scalar(fields[1], "f", 4), "floats")
    assert_bitwise(twp._repeated_scalar([], "d", 8),
                   jwp._repeated_scalar([], "d", 8), "empty")
    for v in (0, 1, 127, 128, 300, 2 ** 32, 2 ** 60):
        assert twp.parse_message(jwp.enc_varint(7, v)) == \
            jwp.parse_message(jwp.enc_varint(7, v))


@pytest.mark.parametrize("extra", [[], ["-r", "0.6", "--first_frame", "1",
                                        "--last_frame", "6"]])
def test_waymo_converter_matches_jax(tmp_path, extra):
    seg = make_waymo_segment(str(tmp_path / "segment.tfrecord"))
    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax_script("convert_waymo",
                   [seg, jdst, "--use_color", "--use_depth"] + extra)
    t_waymo.main([seg, tdst, "--use_color", "--use_depth", "--device",
                  "cpu"] + extra)
    seen = compare_scene_dirs(tdst, jdst)
    assert {"cameras.npz", "points3d.ply", "image/000000.jpg",
            "lidar_depth/000003.npz"} <= set(seen)


def test_waymo_converter_random_colours_match_jax(tmp_path):
    seg = make_waymo_segment(str(tmp_path / "segment.tfrecord"), n_frames=5)
    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax_script("convert_waymo", [seg, jdst, "-r", "0.5", "--seed", "4"])
    t_waymo.main([seg, tdst, "-r", "0.5", "--seed", "4", "--device", "cpu"])
    compare_scene_dirs(tdst, jdst)
