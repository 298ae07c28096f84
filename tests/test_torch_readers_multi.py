"""The port's read_scene and load_frame on the Waymo (cameras.npz) and
nuScenes (meta.npz) layouts against the JAX package's, on
tests/test_readers_multi.py's fixtures (seed 0), with and without the
priors: every FrameInfo field equal (arrays bitwise), the point cloud and
the scene numbers bitwise, one loaded frame's batch bitwise and its camera
within test_torch_core.py's 1e-6 (tests/test_torch_data.py's checks on
the KITTI layout)."""

import numpy as np
import pytest

from adgs_tpu.data import frames as jframes
from adgs_tpu.data import readers as jreaders
from adgs_tpu_torch.data import frames as tframes
from adgs_tpu_torch.data import readers as treaders
from tests.test_readers_multi import make_nuscenes_scene, make_waymo_scene
from tests.test_torch_data import _equal

MAKERS = {"waymo": make_waymo_scene, "nuscenes": make_nuscenes_scene}


@pytest.mark.parametrize("load_priors", [True, False])
@pytest.mark.parametrize("dataset", ["waymo", "nuscenes"])
def test_read_scene_matches_jax(tmp_path, dataset, load_priors):
    root = MAKERS[dataset](str(tmp_path / dataset))
    want = jreaders.read_scene(root, use_colmap=False,
                               load_priors=load_priors)
    got = treaders.read_scene(root, use_colmap=False,
                              load_priors=load_priors)
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
    assert treaders.detect_dataset(root) == dataset

    fr = want.train_frames[1]
    jcam, jbatch, jflow = jframes.load_frame(fr, resolution=1)
    tcam, tbatch, tflow = tframes.load_frame(fr, resolution=1, device="cpu")
    for field in ("image", "depth", "sky", "semantic"):
        g, w = getattr(tbatch, field).numpy(), np.asarray(getattr(jbatch,
                                                                  field))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("world_view", "full_proj", "camera_center", "time"):
        np.testing.assert_allclose(getattr(tcam, field).numpy(),
                                   np.asarray(getattr(jcam, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    for field in ("width", "height", "tan_fovx", "tan_fovy"):
        assert getattr(tcam, field) == pytest.approx(getattr(jcam, field),
                                                     rel=1e-6)
    assert tflow is jflow
