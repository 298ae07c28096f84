"""adgs_tpu_torch.core against adgs_tpu.core on the same numpy inputs:
SH, quaternions (a zero quaternion included), covariance, camera and the
KITTI-75 splines at random times. f32 elementwise: 1e-6 rel / 1e-6 abs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.core import camera as jcam
from adgs_tpu.core import covariance as jcov
from adgs_tpu.core import quaternion as jquat
from adgs_tpu.core import sh as jsh
from adgs_tpu.core import splines as jspl
from adgs_tpu_torch.core import camera as tcam
from adgs_tpu_torch.core import covariance as tcov
from adgs_tpu_torch.core import quaternion as tquat
from adgs_tpu_torch.core import sh as tsh
from adgs_tpu_torch.core import splines as tspl

TOL = dict(rtol=1e-6, atol=1e-6)

KITTI_75 = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
                shs=[0, 0, 0, 6, 0, 0], background=[None, 5, 0, 6, 0, 0])


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_color(rng, deg):
    sh = rng.normal(size=(64, 16, 3)).astype(np.float32)
    means = rng.normal(size=(64, 3)).astype(np.float32)
    means[0] = 0.0                       # direction of length 0
    campos = np.zeros(3, np.float32)
    ref, ref_raw = jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(means),
                                     jnp.asarray(campos))
    port, port_raw = tsh.eval_sh_color(deg, _t(sh), _t(means), _t(campos))
    _close(port, ref)
    _close(port_raw, ref_raw)


def test_quaternion(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                           # zero quaternion (dead slot)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    _close(tquat.normalize(_t(q)), jquat.normalize(jnp.asarray(q)))
    _close(tquat.multiply(_t(q), _t(q2)),
           jquat.multiply(jnp.asarray(q), jnp.asarray(q2)))
    u = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    _close(tquat.unit_to_rotvec(_t(u)), jquat.unit_to_rotvec(jnp.asarray(u)))
    rv = rng.normal(size=(64, 3)).astype(np.float32)
    rv[0] = 0.0
    _close(tquat.rotvec_to_unit(_t(rv)), jquat.rotvec_to_unit(jnp.asarray(rv)))


def test_safe_norm_grad_at_zero():
    q = torch.zeros(2, 4, requires_grad=True)
    tquat.normalize(q).sum().backward()
    assert torch.isfinite(q.grad).all()


def test_covariance(rng):
    cam = tcam.Camera.create(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                             fovx=1.1, fovy=0.9, width=64, height=48,
                             device="cpu")
    jc = jcam.Camera.create(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                            fovx=1.1, fovy=0.9, width=64, height=48)
    s = np.exp(rng.normal(size=(128, 3)) * 0.5 - 2).astype(np.float32)
    q = rng.normal(size=(128, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mv = rng.normal(size=(128, 3)).astype(np.float32)
    mv[:, 2] = rng.uniform(1.0, 8.0, size=128)
    ref3 = jcov.build_cov3d(jnp.asarray(s), jnp.asarray(q))
    port3 = tcov.build_cov3d(_t(s), _t(q))
    _close(port3, ref3)
    ref2 = jcov.project_cov3d_to_2d(jnp.asarray(mv), ref3, jc.world_view,
                                    jc.focal_x, jc.focal_y, jc.tan_fovx,
                                    jc.tan_fovy)
    port2 = tcov.project_cov3d_to_2d(_t(mv), _t(np.asarray(ref3)),
                                     cam.world_view, cam.focal_x, cam.focal_y,
                                     cam.tan_fovx, cam.tan_fovy)
    for name in ("cov", "conic", "det", "radius"):
        _close(getattr(port2, name), getattr(ref2, name))


def test_camera(rng):
    a = rng.normal(size=3) * 0.2
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(a).as_matrix()
    T = np.array([0.3, -0.2, 5.0])
    jc = jcam.Camera.create(R=R, T=T, fovx=1.2, fovy=0.8, width=96,
                            height=64, time=0.4)
    tc = tcam.Camera.create(R=R, T=T, fovx=1.2, fovy=0.8, width=96,
                            height=64, time=0.4, device="cpu")
    for name in ("world_view", "full_proj", "camera_center", "time"):
        _close(getattr(tc, name), getattr(jc, name))
    assert (tc.focal_x, tc.focal_y) == pytest.approx((jc.focal_x, jc.focal_y))
    p = rng.normal(size=(64, 3)).astype(np.float32)
    _close(tcam.transform_point_4x4(_t(p), tc.full_proj),
           jcam.transform_point_4x4(jnp.asarray(p), jc.full_proj))
    _close(tcam.transform_point_4x3(_t(p), tc.world_view),
           jcam.transform_point_4x3(jnp.asarray(p), jc.world_view))
    _close(tcam.ndc_to_pix(_t(p), 96), jcam.ndc_to_pix(jnp.asarray(p), 96))
    assert tcam.focal2fov(700.0, 1242) == jcam.focal2fov(700.0, 1242)


@pytest.mark.parametrize("key", ["xyz", "rotation", "shs", "background"])
def test_splines_kitti75(rng, key):
    cfg_j = jspl.default_basis_config(KITTI_75[key], 60)
    cfg_t = tspl.default_basis_config(KITTI_75[key], 60)
    assert tuple(cfg_j) == tuple(cfg_t)
    rows = 4 if key == "rotation" else 3
    param = (rng.normal(size=(32, rows, cfg_t.param_count)) * 0.3
             ).astype(np.float32)
    for t in list(rng.uniform(size=4)) + [0.0, 0.999]:
        tj = jnp.float32(t)
        tt = torch.tensor(t, dtype=torch.float32)
        if cfg_t.quat_ctrl:
            _close(tspl.eval_quat_trajectory(tt, _t(param), cfg_t),
                   jspl.eval_quat_trajectory(tj, jnp.asarray(param), cfg_j),
                   **TOL)
        else:
            _close(tspl.eval_trajectory(tt, _t(param), cfg_t),
                   jspl.eval_trajectory(tj, jnp.asarray(param), cfg_j))


@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_deboor_cox(order):
    np.testing.assert_array_equal(tspl.deboor_cox_matrix(order),
                                  jspl.deboor_cox_matrix(order))


def _quats(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                           # a dead slot's zero quaternion
    q[1] = [2.0, 0.0, 0.0, 0.0]          # zero vector part
    return q


@pytest.mark.parametrize("normalized", [False, True])
def test_to_rotation_matrix(rng, normalized):
    q = _quats(rng)
    if normalized:
        q[0] = [1.0, 0.0, 0.0, 0.0]
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _close(tquat.to_rotation_matrix(_t(q), normalized=normalized),
           jquat.to_rotation_matrix(jnp.asarray(q), normalized=normalized))


@pytest.mark.parametrize("fn", ["log", "exp"])
def test_quaternion_log_exp(rng, fn):
    q = _quats(rng) * 0.7
    q[2] = [0.3, 1e-9, 0.0, 0.0]         # below the small-angle guard
    _close(getattr(tquat, fn)(_t(q)), getattr(jquat, fn)(jnp.asarray(q)))


def test_sh_to_rgb(rng):
    sh = rng.normal(size=(32, 1, 3)).astype(np.float32)
    _close(tsh.sh_to_rgb(_t(sh)), jsh.sh_to_rgb(jnp.asarray(sh)))
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(_t(sh))).numpy(),
                               sh, **TOL)


def test_fov2focal():
    for fov, px in ((1.1, 48), (0.3, 1242), (2.0, 375)):
        assert tcam.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        assert abs(tcam.focal2fov(tcam.fov2focal(fov, px), px) - fov) < 1e-12
