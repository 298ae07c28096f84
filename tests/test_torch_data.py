"""The port's scene and frame readers (data/readers.py, data/frames.py,
data/ply.py) against the JAX package's on tests/test_data_cli.py's
synthetic KITTI scene: every FrameInfo field equal (arrays bitwise), the
fused point cloud and the scene numbers bitwise; a loaded frame's batch
bitwise, its camera within test_torch_core.py's 1e-6, its flow package
equal."""

import numpy as np
import pytest

from adgs_tpu.data import frames as jframes
from adgs_tpu.data import ply as jply
from adgs_tpu.data import readers as jreaders
from adgs_tpu_torch.data import frames as tframes
from adgs_tpu_torch.data import ply as tply
from adgs_tpu_torch.data import readers as treaders
from tests.test_data_cli import make_kitti_scene


def _equal(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if a.dtype == object:      # a flow package: [time, K, R, T, ...]
            _equal(list(a), list(b), what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


@pytest.mark.parametrize("load_priors", [True, False])
def test_read_scene_matches_jax(tmp_path, load_priors):
    root = make_kitti_scene(str(tmp_path / "scene"))
    want = jreaders.read_scene(root, load_priors=load_priors)
    got = treaders.read_scene(root, load_priors=load_priors)
    for name in ("train_frames", "test_frames"):
        fw, fg = getattr(want, name), getattr(got, name)
        assert len(fg) == len(fw) > 0
        for a, b in zip(fg, fw):
            for field in jreaders.FrameInfo._fields:
                _equal(getattr(a, field), getattr(b, field),
                       f"{name} {b.uid} {field}")
    for field in ("points", "colors", "times", "obj_id", "cameras_extent",
                  "scene_extent", "frame_gap"):
        _equal(getattr(got, field), getattr(want, field), field)
    _equal(list(got.bound), list(want.bound), "bound")
    assert treaders.detect_dataset(root) == "kitti"


def test_load_frame_matches_jax(tmp_path):
    root = make_kitti_scene(str(tmp_path / "scene"))
    fr = jreaders.read_scene(root).train_frames[1]
    jcam, jbatch, jflow = jframes.load_frame(fr, resolution=1)
    tcam, tbatch, tflow = tframes.load_frame(fr, resolution=1, device="cpu")
    for field in ("image", "depth", "sky", "semantic"):
        got, want = getattr(tbatch, field).numpy(), np.asarray(getattr(jbatch,
                                                                       field))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert tbatch.flow is None and tbatch.flow_valid is None
    for field in ("world_view", "full_proj", "camera_center", "time"):
        np.testing.assert_allclose(getattr(tcam, field).numpy(),
                                   np.asarray(getattr(jcam, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    for field in ("width", "height", "tan_fovx", "tan_fovy"):
        assert getattr(tcam, field) == pytest.approx(getattr(jcam, field),
                                                     rel=1e-6)
    assert tflow is jflow
    jpkg, tpkg = jframes.flow_package(jflow[0]), tframes.flow_package(
        tflow[0], device="cpu")
    for field in jpkg._fields:
        got, want = getattr(tpkg, field).numpy(), np.asarray(getattr(jpkg,
                                                                     field))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_load_frame_resized(tmp_path):
    """A resolution divisor of 2: the PIL bilinear image, depth and sky
    resizes and the nearest semantic sampling, as the JAX package."""
    root = make_kitti_scene(str(tmp_path / "scene"))
    fr = jreaders.read_scene(root).test_frames[0]
    _, jbatch, _ = jframes.load_frame(fr, resolution=2)
    tcam, tbatch, _ = tframes.load_frame(fr, resolution=2, device="cpu")
    assert (tcam.width, tcam.height) == (48, 32)
    for field in ("image", "depth", "sky", "semantic"):
        np.testing.assert_array_equal(getattr(tbatch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)),
                                      err_msg=field)


def test_ply_files_interchange(tmp_path, rng):
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cols = (rng.uniform(size=(20, 3)) * 255).astype(np.float32)
    t = rng.uniform(size=20).astype(np.float32)
    obj = (rng.random(20) < 0.5).astype(np.float32)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.store_point_cloud(jp, pts, cols, t, obj)
    tply.store_point_cloud(tp, pts, cols, t, obj)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for a, b in zip(tply.fetch_point_cloud(jp), jply.fetch_point_cloud(tp)):
        np.testing.assert_array_equal(a, b)
