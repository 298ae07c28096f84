"""The plain twin of kernel B7 and the environment map against the JAX
package: the blocked Pallas sample (interpret mode, 256^2 grid) and the
generic align_corners sample, with coords off the grid too (1e-6 abs);
image_background (1e-5); and the sky backward (the plain twin of B8)
against the JAX package's VJPs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.models import env_map as jenv
from adgs_tpu.ops import grid_sample as jgs
from adgs_tpu_torch.models import env_map as tenv
from adgs_tpu_torch.ops import grid_sample as tgs


def _grid(rng, c=3, r=256):
    return rng.normal(size=(c, r, r)).astype(np.float32)


def _smooth_grid(rng, c=3, r=256):
    """Values of order 1 that vary over ~16 cells, like a trained sky.
    The two packages' ray angles differ in the last bit (atan2, hypot and
    the 3x3 product round differently), which moves each tap by a few ulps
    of its cell coordinate; on i.i.d. N(0,1) cells at r=256 that gap
    reached 1.06e-5 at one pixel in 2880 (seed 0)."""
    from scipy.ndimage import zoom
    coarse = rng.normal(size=(c, r // 16, r // 16))
    return zoom(coarse, (1, 16, 16), order=1).astype(np.float32)


def _coords(rng, h, w, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=(h, w, 2)).astype(np.float32)


def test_plain_matches_generic_with_off_grid(rng):
    grid = _grid(rng, r=40)
    coords = _coords(rng, 24, 30, -1.3, 1.3)      # some taps fall off the grid
    coords[0, 0] = [1.0, 1.0]                     # exact corner
    coords[0, 1] = [-1.0, -1.0]
    ref = jenv._grid_sample_align_corners(jnp.asarray(grid),
                                          jnp.asarray(coords))
    port = tgs.grid_sample_torch(torch.as_tensor(grid), torch.as_tensor(coords))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # the wrapper on CPU tensors is the plain twin
    np.testing.assert_array_equal(
        tgs.grid_sample(torch.as_tensor(grid), torch.as_tensor(coords)).numpy(),
        port.numpy())
    # matches torch's own grid_sample contract
    lib = torch.nn.functional.grid_sample(
        torch.as_tensor(grid)[None], torch.as_tensor(coords)[None],
        align_corners=True, padding_mode="zeros")[0]
    np.testing.assert_allclose(port.numpy(), lib.numpy(), rtol=0, atol=1e-5)


def test_plain_matches_blocked_pallas(rng):
    # a 256^2 grid takes the blocked Pallas branch (>= the 48x256 window);
    # smooth horizon-like coords so the blocks' windows cover their taps
    grid = _grid(rng)
    h, w = 24, 64
    ys, xs = np.meshgrid(np.linspace(-0.2, 0.2, h), np.linspace(-0.3, 0.3, w),
                         indexing="ij")
    coords = np.stack([xs, ys], -1).astype(np.float32)
    ref = jgs.grid_sample_image(jnp.asarray(grid), jnp.asarray(coords))
    port = tgs.grid_sample_torch(torch.as_tensor(grid), torch.as_tensor(coords))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("res", [64, 256])
def test_image_background(rng, res):
    grid = _smooth_grid(rng, r=res)
    h, w = 24, 40
    rays = jenv.camera_rays(30.0, h, w)
    assert np.array_equal(rays, tenv.camera_rays(30.0, h, w))
    # horizon-looking pose: camera +z -> world +x
    M = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    a = rng.normal(size=3).astype(np.float32) * 0.1
    wv = np.eye(4, dtype=np.float32)
    wv[:3, :3] = M.T
    wv[3, :3] = a
    ref = jenv.EnvironmentMap(grid=jnp.asarray(grid)).image_background(
        jnp.asarray(rays), jnp.asarray(wv))
    port = tenv.EnvironmentMap(grid=torch.as_tensor(grid)).image_background(
        torch.as_tensor(rays), torch.as_tensor(wv))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_create_matches():
    j = jenv.EnvironmentMap.create(32, seed=5)
    t = tenv.EnvironmentMap.create(32, seed=5, device="cpu")
    np.testing.assert_array_equal(t.grid.numpy(), np.asarray(j.grid))


def _sky_grad_port(grid, coords, g):
    t = torch.as_tensor(grid).requires_grad_(True)
    out = tgs.GridSample.apply(t, torch.as_tensor(coords))
    (d,) = torch.autograd.grad((out * torch.as_tensor(g)).sum(), t)
    return d.numpy()


@pytest.mark.parametrize("path", ["generic", "blocked"])
def test_sky_grad_matches_jax(rng, path):
    """The grid gradient through the port's sky Function (the plain twin of
    B8 on CPU tensors) against the JAX package's backward: the flat scatter
    of _grid_sample_bwd (40^2 grid) and grid_sample_image's VJP (256^2 grid,
    interpret mode), with taps off the grid in both (1e-5 rel, 1e-6 abs,
    as tests/test_grid_sample.py)."""
    if path == "generic":
        grid = _grid(rng, r=40)
        coords = _coords(rng, 24, 30, -1.3, 1.3)
        fn = jenv._grid_sample_align_corners
    else:
        grid = _grid(rng)
        h, w = 24, 64
        ys, xs = np.meshgrid(np.linspace(-0.2, 0.2, h),
                             np.linspace(-0.3, 0.3, w), indexing="ij")
        coords = np.stack([xs, ys], -1).astype(np.float32)
        coords[0, :8] = [[1.0 + 0.004 * k, 0.1] for k in range(8)]
        fn = jgs.grid_sample_image
    g = rng.normal(size=(3,) + coords.shape[:2]).astype(np.float32)
    _, vjp = jax.vjp(lambda gr: fn(gr, jnp.asarray(coords)), jnp.asarray(grid))
    (want,) = vjp(jnp.asarray(g))
    got = _sky_grad_port(grid, coords, g)
    assert np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # the twin on its own, and no gradient for the coordinates
    np.testing.assert_array_equal(
        tgs.grid_sample_bwd(torch.as_tensor(g), torch.as_tensor(coords),
                            grid.shape).numpy(), got)
    c = torch.as_tensor(coords).requires_grad_(True)
    out = tgs.GridSample.apply(torch.as_tensor(grid), c)
    (dc,) = torch.autograd.grad(out.sum(), c, allow_unused=True)
    assert dc is None
