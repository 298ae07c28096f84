"""adgs_tpu_torch.raster.preprocess against adgs_tpu.raster.preprocess on
the same activated inputs: tile rects, tiles_touched and visibility are
equal; floats agree to 1e-5 relative."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster import preprocess as jprep
from adgs_tpu_torch.core.camera import Camera
from adgs_tpu_torch.raster import preprocess as tprep
from adgs_tpu_torch.raster.types import RasterSettings
from tests import scene_fixtures as fx


def port_settings(js, device="cpu") -> RasterSettings:
    """The port's settings for a JAX RasterSettings."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    return RasterSettings(
        viewmatrix=t(js.viewmatrix), projmatrix=t(js.projmatrix),
        campos=t(js.campos), bg=t(js.bg), image_height=js.image_height,
        image_width=js.image_width, tanfovx=js.tanfovx, tanfovy=js.tanfovy,
        sh_degree=js.sh_degree, scale_modifier=js.scale_modifier,
        inv_depth=js.inv_depth)


def make_case(rng, n=2048, w=128, h=96, dead_frac=0.0, op_low=0.05):
    """(JAX settings, gaussian dict of numpy arrays, active mask)."""
    cam = fx.make_camera(width=w, height=h, rng=rng)
    js = fx.settings_from_camera(cam, bg=(0.2, 0.3, 0.1))
    g = {k: np.array(v) for k, v in fx.make_gaussians(rng, n=n).items()}
    g["opacities"] = rng.uniform(op_low, 0.95, size=n).astype(np.float32)
    # a few Gaussians behind the camera, and a few below the 1/255 gate
    g["means3d"][: n // 32, 2] = -6.0
    g["opacities"][n // 32: n // 16] = 0.003
    active = rng.random(n) >= dead_frac
    return js, g, active


def run_both(js, g, active, with_sh=True):
    jp = jprep.preprocess(jnp.asarray(g["means3d"]), jnp.asarray(g["scales"]),
                          jnp.asarray(g["rotations"]),
                          jnp.asarray(g["opacities"]),
                          jnp.asarray(g["shs"]) if with_sh else None, js,
                          active_mask=jnp.asarray(active))
    tp = tprep.preprocess(*(torch.as_tensor(g[k]) for k in
                            ("means3d", "scales", "rotations", "opacities")),
                          torch.as_tensor(g["shs"]) if with_sh else None,
                          port_settings(js), active_mask=torch.as_tensor(active))
    return jp, tp


@pytest.mark.parametrize("dead_frac", [0.0, 0.5])
def test_preprocess_matches(rng, dead_frac):
    js, g, active = make_case(rng, dead_frac=dead_frac)
    jp, tp = run_both(js, g, active)
    for name in ("rect_min", "rect_max", "tiles_touched", "visible"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    vis = np.asarray(jp.visible)
    assert 0 < vis.sum() < vis.size
    for name in ("mean2d", "conic", "depth", "rgb", "radii", "extent",
                 "opacity"):
        np.testing.assert_allclose(getattr(tp, name).numpy()[vis],
                                   np.asarray(getattr(jp, name))[vis],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_get_rect_saturates_like_xla():
    """Non-finite centres clip the same way as XLA's saturating
    float->int conversion."""
    m = np.array([[np.inf, -np.inf], [np.nan, 5.0], [1e20, -1e20]],
                 np.float32)
    e = np.ones((3, 2), np.float32)
    jmin, jmax = jprep.get_rect(jnp.asarray(m), jnp.asarray(e), 8, 6)
    tmin, tmax = tprep.get_rect(torch.as_tensor(m), torch.as_tensor(e), 8, 6)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))


def test_port_camera_settings_match():
    cam = fx.make_camera(width=64, height=48)
    tc = Camera.create(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.1,
                       fovy=0.9, width=64, height=48, device="cpu")
    np.testing.assert_allclose(tc.full_proj.numpy(), np.asarray(cam.full_proj),
                               rtol=1e-6, atol=1e-7)
    ps = port_settings(fx.settings_from_camera(cam))
    assert (ps.grid_x, ps.grid_y, ps.num_tiles) == (4, 3, 12)
