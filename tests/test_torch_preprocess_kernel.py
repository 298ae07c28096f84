"""Kernels P1 and P2 (csrc/preprocess.cu) and their plain twins.

On the CPU: P2's closed-form twin (`preprocess_bwd_torch`) against
autograd through the plain `preprocess_torch`, worst leaf by norm, over SH
degrees, precomputed colours, with and without screen_offset, and slots
that are dead, behind the camera, below the 1/255 gate, frustum-clamped,
clamped to rgb 0 (also exactly at 0) and at det == 0 or near it, and
with rgb taken as P1 writes it (0 off the visible slots); and the plain
path that CPU tensors and `_kernels.plain()` take, bitwise the frozen copy
of the plain tier (port_bench/reference/plain) in outputs and gradients.
On the card (the `card` fixture skips them elsewhere; run with
`python -m pytest --noconftest tests/test_torch_preprocess_kernel.py`):
P1's integer outputs bitwise the plain version's at the three benchmark
cameras and its floats within 1e-6, P2 within 1e-6 of the twin, the
launch counts, and no host synchronize. This file imports no JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from adgs_tpu_torch import _kernels
from adgs_tpu_torch.core.camera import Camera
from adgs_tpu_torch.core import sh as sh_lib
from adgs_tpu_torch.core.covariance import build_cov3d, project_cov3d_to_2d
from adgs_tpu_torch.core.camera import transform_point_4x3
from adgs_tpu_torch.raster import preprocess as prep
from adgs_tpu_torch.render import settings_for_camera

# width, height, focal of the benchmark's cameras (port_bench/configs)
CAMERAS = {"kitti-75": (1242, 375, 721.5377), "waymo": (1920, 1280, 2055.0),
           "nuscenes": (1600, 900, 1266.4)}
# configs/kitti-75.py's order arguments
KITTI_75 = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
                shs=[0, 0, 0, 6, 0, 0], background=[None, 5, 0, 6, 0, 0])
GRAD_FIELDS = ("mean2d", "depth", "conic", "rgb")
INT_FIELDS = ("rect_min", "rect_max", "tiles_touched", "visible")
FLOAT_FIELDS = ("mean2d", "depth", "conic", "radii", "extent", "opacity")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: P1 and P2 run only there")
    return torch.device("cuda", 0)


def rot(ax, ay, az):
    cx, sx, cy, sy = math.cos(ax), math.sin(ax), math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


POSE = (rot(0.05, 0.1, -0.03), np.array([0.3, -0.2, 0.5]))
# world = camera: p_view is exact, so a slot can sit on the frustum clamp
IDENTITY = (np.eye(3), np.zeros(3))


def make_settings(width=160, height=96, focal=120.0, sh_degree=3,
                  device="cpu", dtype=torch.float32, pose=POSE):
    R, T = pose
    cam = Camera.create(R=R, T=T, fovx=2 * math.atan(width / (2 * focal)),
                        fovy=2 * math.atan(height / (2 * focal)),
                        width=width, height=height, device=device)
    st = settings_for_camera(cam, sh_degree)
    return dataclasses.replace(
        st, viewmatrix=st.viewmatrix.to(dtype),
        projmatrix=st.projmatrix.to(dtype), campos=st.campos.to(dtype))


def to_world(p_cam, pose=POSE):
    """Camera-frame points (x right, y down, z ahead) to world points."""
    R, T = pose
    return (p_cam - T) @ R      # world->camera is R p + T


def make_gaussians(rng, n, width, height, focal, k=16, pose=POSE):
    """Slots in front of the camera, on and off screen, with every edge
    case in its own share: behind the camera, dead (zeros, identity
    rotation, opacity sigmoid(-15), inactive), below the gate, far off to
    the side (frustum clamp) and colours below 0."""
    z = rng.uniform(1.0, 40.0, n)
    tanx, tany = width / (2 * focal), height / (2 * focal)
    x = rng.uniform(-1.1, 1.1, n) * tanx * z
    y = rng.uniform(-1.1, 1.1, n) * tany * z
    p = np.stack([x, y, z], -1)
    q = n // 16
    p[:q, 2] = rng.uniform(-5.0, 0.19, q)                   # behind
    p[q:2 * q, 0] = rng.choice([-1, 1], q) * 3.0 * tanx * p[q:2 * q, 2]
    g = dict(means3d=to_world(p, pose),
             scales=np.exp(rng.normal(-1.5, 0.6, (n, 3))),
             rotations=rng.normal(size=(n, 4)),
             opacities=rng.uniform(0.02, 0.99, n),
             shs=rng.normal(0.0, 0.3, (n, k, 3)))
    g["rotations"] /= np.linalg.norm(g["rotations"], axis=-1, keepdims=True)
    g["opacities"][2 * q:3 * q] = 0.003                     # below the gate
    g["shs"][3 * q:4 * q, 0] = -3.0                         # rgb clamped
    dead = slice(4 * q, 5 * q)
    g["means3d"][dead] = 0.0
    g["scales"][dead] = 1.0
    g["rotations"][dead] = (1.0, 0.0, 0.0, 0.0)
    g["opacities"][dead] = 1.0 / (1.0 + math.exp(15.0))
    active = np.ones(n, bool)
    active[dead] = False
    return {k: v.astype(np.float32) for k, v in g.items()}, active


def det_edge_slots(st, rng, n=4096):
    """Needles lying at 45 degrees across the image with ~1e7 px^2 of
    variance, where cxx * cyy and cxy^2 round to within a few ulps:
    (the slots whose det is exactly 0, those whose det is within 1e-5 of
    cxx * cyy). Returns the Gaussian fields of both, in float32."""
    z = rng.uniform(3.0, 6.0, n)
    p = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n), z], -1)
    half = np.pi / 8 + rng.normal(0, 1e-3, n)          # 45 deg about z
    R = POSE[0]
    qc = np.stack([np.cos(half), np.zeros(n), np.zeros(n), np.sin(half)], -1)
    # camera-frame rotation to world: q_world = q(R^T) * q_cam
    w = 0.5 * math.sqrt(1 + np.trace(R.T))
    rt = R.T
    qr = np.array([w, (rt[2, 1] - rt[1, 2]) / (4 * w),
                   (rt[0, 2] - rt[2, 0]) / (4 * w),
                   (rt[1, 0] - rt[0, 1]) / (4 * w)])
    a1, b1, c1, d1 = qr
    a2, b2, c2, d2 = qc.T
    qw = np.stack([a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
                   a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
                   a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
                   a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2], -1)
    g = dict(means3d=to_world(p), rotations=qw,
             scales=np.stack([z * rng.uniform(25.0, 60.0, n),
                              np.full(n, 1e-3), np.full(n, 1e-3)], -1),
             opacities=rng.uniform(0.3, 0.9, n),
             shs=rng.normal(0.0, 0.3, (n, 16, 3)))
    g = {k: torch.as_tensor(v.astype(np.float32)) for k, v in g.items()}
    pv = transform_point_4x3(g["means3d"], st.viewmatrix)
    c2 = project_cov3d_to_2d(pv, build_cov3d(g["scales"], g["rotations"]),
                             st.viewmatrix, st.focal_x, st.focal_y,
                             st.tanfovx, st.tanfovy)
    scale = c2.cov[:, 0] * c2.cov[:, 2]
    zero = c2.det == 0
    near = ~zero & (c2.det.abs() < 1e-5 * scale)
    assert zero.sum() >= 4 and near.sum() >= 4, (int(zero.sum()),
                                                 int(near.sum()))
    pick = torch.cat([torch.nonzero(zero)[:16, 0],
                      torch.nonzero(near)[:16, 0]])
    return {k: v[pick].numpy() for k, v in g.items()}


def cotangents(rng, n, zero_share=0.25):
    """N(0, 1) cotangents of mean2d, depth, conic and rgb; a share of the
    slots gets all four zero."""
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((n, 2), (n,), (n, 3), (n, 3))]
    off = rng.random(n) < zero_share
    for x in g:
        x[off] = 0.0
    return [torch.as_tensor(x) for x in g], torch.as_tensor(off)


def autograd_grads(g, st, cots, colors=None, offset=True, active=None,
                   gate=False):
    """dL/d(means3d, scales, rotations, shs, screen_offset) of
    sum(cot * output) through the plain preprocess; with `gate`, rgb as P1
    writes it: 0 where the slot is not visible."""
    leaves = {k: torch.as_tensor(g[k]).clone().requires_grad_(True)
              for k in ("means3d", "scales", "rotations", "shs")}
    n = leaves["means3d"].shape[0]
    so = (torch.zeros((n, 2), dtype=leaves["means3d"].dtype,
                      requires_grad=True) if offset else None)
    out = prep.preprocess_torch(
        leaves["means3d"], leaves["scales"], leaves["rotations"],
        torch.as_tensor(g["opacities"]),
        None if colors is not None else leaves["shs"], st,
        colors_precomp=colors, screen_offset=so, active_mask=active)
    if gate:
        out = out._replace(rgb=torch.where(out.visible[:, None], out.rgb,
                                           0.0))
    loss = sum((c * getattr(out, f)).sum() for c, f in zip(cots, GRAD_FIELDS)
               if not (f == "rgb" and colors is not None))
    names = ["means3d", "scales", "rotations"] + (
        ["shs"] if colors is None else [])
    wrt = [leaves[k] for k in names] + ([so] if offset else [])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return {k: (torch.zeros_like(w) if gr is None else gr)
            for k, w, gr in zip(names + ["screen_offset"], wrt, grads)}


def worst_leaf(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).norm() / want[k].norm().clamp_min(
        1e-30)) for k in want)


BWD_CASES = {
    "sh0": dict(deg=0), "sh1": dict(deg=1), "sh2": dict(deg=2),
    "sh3": dict(deg=3), "sh3_no_offset": dict(deg=3, offset=False),
    "colors_precomp": dict(deg=3, colors=True),
    "det_edges": dict(deg=3, det=True),
    "frustum_edges": dict(deg=3, edges=True),
    "visible_gate": dict(deg=3, gate=True),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_twin_matches_autograd(case):
    """P2's twin within 1e-5 of autograd through the plain preprocess
    (relative, the worst leaf by norm); slots whose cotangents are all
    zero get exact zeros. `gate`: the twin given the radii against
    autograd of rgb as P1 writes it (0 off the visible slots), with
    cotangents on every slot."""
    c = BWD_CASES[case]
    rng = np.random.default_rng(20 + len(case))
    pose = IDENTITY if c.get("edges") else POSE
    st = make_settings(sh_degree=c["deg"], pose=pose)
    g, active = make_gaussians(rng, 1024, 160, 96, 120.0, pose=pose)
    if c.get("edges"):
        # tx / tz and ty / tz exactly at +-1.3 tan(fov / 2), where the
        # clamp still passes gradient
        limx = np.float32(1.3 * st.tanfovx)
        limy = np.float32(1.3 * st.tanfovy)
        z = np.float32(2.0) ** rng.integers(0, 4, 64)
        edge_x = np.stack([np.repeat([limx, -limx], 32) * z,
                           rng.uniform(-0.3, 0.3, 64) * z, z], -1)
        edge_y = np.stack([rng.uniform(-0.3, 0.3, 64) * z,
                           np.repeat([limy, -limy], 32) * z, z], -1)
        g["means3d"][-128:] = np.concatenate([edge_x, edge_y]).astype(
            np.float32)
        active[-128:] = True
    # colours exactly at the clamp's edge: raw = b0 sh0 + 0.5 = 0 with the
    # slot's other coefficients 0
    edge = slice(0, 8)
    g["shs"][edge] = 0.0
    sh0 = np.float32(-0.5 / np.float32(0.28209479177387814))
    while np.float32(np.float32(0.28209479177387814) * sh0) != -0.5:
        sh0 = np.nextafter(sh0, np.float32(0.0))
    g["shs"][edge, 0, :] = sh0
    if c.get("det"):
        e = det_edge_slots(st, rng)
        m = e["means3d"].shape[0]
        for k in e:
            g[k][-m:] = e[k]
        active[-m:] = True
    n = g["means3d"].shape[0]
    cots, off = cotangents(rng, n)
    colors = (torch.as_tensor(rng.uniform(-0.2, 1.2, (n, 3))
                              .astype(np.float32))
              if c.get("colors") else None)
    want = autograd_grads(g, st, cots, colors=colors,
                          offset=c.get("offset", True),
                          active=torch.as_tensor(active),
                          gate=c.get("gate", False))
    t = {k: torch.as_tensor(g[k]) for k in g}
    visible = radii = None
    if c.get("gate"):
        fwd = prep.preprocess_torch(
            t["means3d"], t["scales"], t["rotations"], t["opacities"],
            t["shs"], st, active_mask=torch.as_tensor(active))
        visible, radii = fwd.visible, fwd.radii
        assert torch.equal(radii > 0, visible)
    gm, gs, gr, gsh = prep.preprocess_bwd_torch(
        t["means3d"], t["scales"], t["rotations"],
        None if colors is not None else t["shs"], st, *cots, radii=radii)
    if visible is not None:
        assert 0 < int(visible.sum()) < n
        assert torch.count_nonzero(gsh[~visible]) == 0
    got = dict(means3d=gm, scales=gs, rotations=gr)
    if colors is None:
        got["shs"] = gsh
    else:
        assert gsh is None
    if c.get("offset", True):
        got["screen_offset"] = cots[0]
    err = worst_leaf(got, want)
    assert err < 1e-5, (case, {k: float((got[k] - want[k]).norm()
                                        / want[k].norm()) for k in want})
    if c.get("edges"):
        # the edge slots alone: their clamp terms are small beside the
        # other slots' gradients
        edge = worst_leaf({k: v[-128:] for k, v in got.items()},
                          {k: v[-128:] for k, v in want.items()})
        assert edge < 1e-5, edge
    for k, v in got.items():
        if k != "screen_offset":
            assert torch.count_nonzero(v[off]) == 0, k


def frozen_plain():
    from port_bench.reference.plain.raster import preprocess as frozen
    return frozen


def test_cpu_path_bitwise_frozen_plain():
    """CPU tensors run today's plain version: outputs and gradients
    bitwise the frozen copy's."""
    frozen = frozen_plain()
    rng = np.random.default_rng(5)
    st = make_settings()
    g, active = make_gaussians(rng, 512, 160, 96, 120.0)
    cots, _ = cotangents(rng, 512)
    runs = []
    for fn in (prep.preprocess, frozen.preprocess):
        leaves = {k: torch.as_tensor(g[k]).clone().requires_grad_(True)
                  for k in g if k != "opacities"}
        so = torch.zeros((512, 2), requires_grad=True)
        out = fn(leaves["means3d"], leaves["scales"], leaves["rotations"],
                 torch.as_tensor(g["opacities"]), leaves["shs"], st,
                 screen_offset=so, active_mask=torch.as_tensor(active))
        loss = sum((c * getattr(out, f)).sum()
                   for c, f in zip(cots, GRAD_FIELDS))
        grads = torch.autograd.grad(loss, list(leaves.values()) + [so])
        runs.append((out, grads))
    (out, grads), (ref, ref_grads) = runs
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)
    assert _kernels.launches["preprocess"] == 0


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------

def card_case(dev, cam, n=200_000, seed=3):
    width, height, focal = CAMERAS[cam]
    rng = np.random.default_rng(seed)
    st = make_settings(width, height, focal, device=dev)
    g, active = make_gaussians(rng, n, width, height, focal)
    t = {k: torch.as_tensor(v, device=dev) for k, v in g.items()}
    return st, t, torch.as_tensor(active, device=dev)


def sh_order_units(got, want, t, st, vis) -> float:
    """The largest |P1 - plain| of rgb on the visible slots, in units of
    2^-24 (sum_k |b_k sh_k| + 0.5): both sum the same K rounded terms, in
    another order, which moves each sum by at most ~K such units."""
    d = t["means3d"] - st.campos
    u = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    b = sh_lib.sh_basis(st.sh_degree, u)
    mag = (b[:, :, None].abs() * t["shs"][:, :b.shape[1]].abs()).sum(1)
    units = (got - want).abs() / ((mag + 0.5) * 2.0 ** -24)
    return float(units[vis].max())


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_p1_matches_plain_on_card(card, cam):
    """P1 at the benchmark's camera shapes: every output bitwise the
    plain version's but rgb, whose SH sum P1 takes in another order: on
    visible slots within 2K units of that order's rounding (K = 16
    coefficients), and 0 elsewhere, where P1 writes it."""
    st, t, active = card_case(card, cam)
    so = torch.zeros((t["means3d"].shape[0], 2), device=card)
    args = (t["means3d"], t["scales"], t["rotations"], t["opacities"],
            t["shs"], st)
    kw = dict(screen_offset=so, active_mask=active)
    _kernels.reset_launches()
    got = prep.preprocess(*args, **kw)
    assert _kernels.launches["preprocess"] == 1
    with _kernels.plain():
        want = prep.preprocess(*args, **kw)
    for f in INT_FIELDS + FLOAT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    vis = want.visible
    assert 0 < int(vis.sum()) < vis.numel()
    assert sh_order_units(got.rgb, want.rgb, t, st, vis) <= 32
    assert torch.count_nonzero(got.rgb[~vis]) == 0


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_p2_matches_twin_on_card(card, cam):
    """P2 within 1e-6 of its twin (relative, the worst leaf by norm), and
    through autograd: one launch, screen_offset's gradient dL/dmean2d, rgb's
    cotangent taken only on visible slots."""
    st, t, active = card_case(card, cam)
    rng = np.random.default_rng(11)
    n = t["means3d"].shape[0]
    cots, off = cotangents(rng, n)
    cots = [c.to(card) for c in cots]
    fwd = prep.preprocess_torch(t["means3d"], t["scales"], t["rotations"],
                                t["opacities"], t["shs"], st,
                                active_mask=active)
    vis = fwd.visible
    want = prep.preprocess_bwd_torch(t["means3d"], t["scales"],
                                     t["rotations"], t["shs"], st, *cots,
                                     radii=fwd.radii)
    leaves = {k: t[k].clone().requires_grad_(True)
              for k in ("means3d", "scales", "rotations", "shs")}
    so = torch.zeros((n, 2), device=card, requires_grad=True)
    _kernels.reset_launches()
    out = prep.preprocess(leaves["means3d"], leaves["scales"],
                          leaves["rotations"], t["opacities"], leaves["shs"],
                          st, screen_offset=so, active_mask=active)
    loss = sum((c * getattr(out, f)).sum() for c, f in zip(cots, GRAD_FIELDS))
    got = torch.autograd.grad(loss, list(leaves.values()) + [so])
    assert _kernels.launches["preprocess"] == 1
    assert _kernels.launches["preprocess_bwd"] == 1
    errs = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    assert max(errs) <= 1e-6, errs
    assert torch.equal(got[4], cots[0])
    for x in got[:4]:
        assert torch.count_nonzero(x[off.to(card)]) == 0
    assert torch.count_nonzero(got[3][~vis]) == 0


def test_launches_and_no_sync_on_card(card):
    """One P1 launch a render() and one P2 launch a backward; P1 and P2
    under set_sync_debug_mode("error"): no host synchronize."""
    from adgs_tpu_torch.models import gaussians as gm
    from adgs_tpu_torch.render import render
    width, height, focal = CAMERAS["kitti-75"]
    rng = np.random.default_rng(7)
    n = 20_000
    pts = to_world(np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                             rng.uniform(5, 30, n)], -1)).astype(np.float32)
    cfg = gm.GaussianConfig.from_order_args(KITTI_75, frame_num=60)
    params, state = gm.create_from_pcd(
        pts, rng.uniform(size=(n, 3)).astype(np.float32),
        (rng.random(n) < 0.3).astype(np.float32),
        rng.uniform(size=n).astype(np.float32), cfg,
        np.full(n, 0.01, np.float32), seed=7, device=card)
    params = dataclasses.replace(params, **{
        f.name: getattr(params, f.name).detach().requires_grad_(True)
        for f in dataclasses.fields(params)})
    R, T = POSE
    cam = Camera.create(R=R, T=T, fovx=2 * math.atan(width / (2 * focal)),
                        fovy=2 * math.atan(height / (2 * focal)),
                        width=width, height=height, time=0.4, device=card)
    so = torch.zeros((params.capacity, 2), device=card, requires_grad=True)
    pkg, _ = gm.deform(params, state, cfg, cam.time)
    ins = [pkg["xyz"], gm.activated_scaling(params), pkg["rotation"],
           pkg["shs"], so]
    st = settings_for_camera(cam, 3)

    def step():
        out = prep.preprocess(ins[0], ins[1], ins[2], pkg["opacity"], ins[3],
                              st, screen_offset=so, active_mask=state.alive)
        loss = (out.mean2d.sum() + out.depth.sum() + out.conic.sum()
                + out.rgb.sum())
        return torch.autograd.grad(loss, ins)

    step()                                      # builds and loads
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _kernels.launches["preprocess"] == 1
    assert _kernels.launches["preprocess_bwd"] == 1
    _kernels.reset_launches()
    out = render(cam, params, state, cfg, screen_offset=so)
    assert _kernels.launches["preprocess"] == 1
    out["render"].sum().backward()
    assert _kernels.launches["preprocess_bwd"] == 1
