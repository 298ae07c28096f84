"""The benchmark's inputs, made from the seed: the model's weights and sky,
the scene's cameras, the training frames and their flow packages.

Everything here is the benchmark's own and is handed, the same, to the
program and to the plain reference. Weights and frames are drawn on the
device with one torch.Generator in a few large calls, in float32.

The model follows bench.py's protocol at a configuration's published
widths: N Gaussians, a share of them object Gaussians, isotropic
log-scales from the expected 3-NN spacing of the cloud, shrunk by
log(0.3) (the instance density of a trained scene). The other leaves are
drawn so that a trained model's work is done: SH of degree 3, opacities
spread about logit(0.12), object trajectories and time masks.

World axes: x forward along the drive, y to the left, z up. The rig's
origin drives along +x from x = -8, `drive_per_timestamp` a timestamp.

The cloud (the configuration's `cloud`, CLOUDS) is one law,
x ~ U(x0, x0 + length), y ~ N(0, sigma_y), z ~ N(0, sigma_z), from one
uniform and two normals a Gaussian; its density at a point is
rho = N / length * exp(-(y / sigma_y)^2 / 2 - (z / sigma_z)^2 / 2)
/ (2 pi sigma_y sigma_z), and _log_spacing turns rho into the log of the
expected 3-NN spacing of a Poisson cloud of that density:

- "forward" (the default): x ~ U(-2, 6), y, z ~ N(0, 4), a block ahead of
  the rig's start that a forward camera looks into. scene_extent (the
  bounding box's diagonal) lands at about 54 with 1M Gaussians, set by
  the normals' extremes in y and z (about +-4.9 sigma).
- "surround": x ~ U(-8, 8), y ~ N(0, 8), z ~ N(0, 4), a band twice as
  wide as it is tall along the drive from the rig's start, reaching to
  both sides of it: a camera turned 55 degrees to the side renders about
  as many instances as the forward one, as on a street lined with
  buildings. scene_extent lands at about 90 with 1M Gaussians.

cameras_extent (1.1 x the largest distance of a training camera's centre
from their mean) lands at 0.90 (kitti-75), 1.09 (waymo) and 1.17 (a
three-camera nuScenes rig over 60 timestamps): slow drives, rigs under
two metres across. So the configuration's min_camera_extent (5 or 10)
is what training uses, in both layouts.

The rig (the configuration's `rig`, see rig()): cameras with a yaw, an
offset from the rig's origin and intrinsics each, all at the
configuration's width x height, as the port's reader gives a multi-camera
scene (each K as its own FoVs, every image at its file's size).
Without `rig`, `num_cam` cameras face forward `baseline` apart to the
right at `focal`, the principal point at the centre.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

HORIZON = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
SH_C0 = 0.28209479177387814
CAPACITY_QUANTUM = 4096
CAP_HEADROOM = 0.92          # instance capacity = max num_rendered / 0.92
# E[r_k^2] of a Poisson process in 3-D is Gamma(k + 2/3) / Gamma(k) times
# (4 pi rho / 3)^(-2/3); the mean over k = 1, 2, 3 (the reader's 3-NN)
KNN3_FACTOR = (math.gamma(5 / 3) + math.gamma(8 / 3) / 1.0
               + math.gamma(11 / 3) / 2.0) / 3.0


def round_capacity(n: int, quantum: int = CAPACITY_QUANTUM) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def instance_capacity(num_rendered: int) -> int:
    """The trainer's overflow guard's size for num_rendered instances."""
    return -(-int(num_rendered / CAP_HEADROOM) // CAPACITY_QUANTUM) \
        * CAPACITY_QUANTUM


# ---------------------------------------------------------------------------
# configuration -> sizes
# ---------------------------------------------------------------------------
def basis_counts(order_args: dict, frame_num: int, downsample: int = 3):
    """Control points of each deformation basis, filled as the reader's
    set_default_param_order fills None entries: {key: (bspline_ctrl,
    bspline_order, poly_order, fft_order, quat_ctrl, quat_order)}."""
    out = {}
    for key in ("xyz", "rotation", "shs", "background"):
        a = list(order_args.get(key) or [None] * 6)
        b_ctrl = a[0] if a[0] is not None else frame_num // downsample
        b_ord = 0
        if b_ctrl > 0:
            b_ord = min(a[1] if a[1] is not None else 5, b_ctrl - 1)
        poly = a[2] if a[2] is not None else frame_num // downsample
        fft = a[3] if a[3] is not None else 6
        q_ctrl = a[4] if a[4] is not None else frame_num // downsample
        q_ord = 0
        if q_ctrl > 0:
            q_ord = min(a[5] if a[5] is not None else 1, q_ctrl - 1)
        out[key] = (b_ctrl, b_ord, poly, fft, q_ctrl, q_ord)
    return out


def param_count(basis: tuple) -> int:
    b_ctrl, _, poly, fft, q_ctrl, _ = basis
    return b_ctrl + poly + 2 * fft + q_ctrl


class Sizes(NamedTuple):
    n_scene: int
    n_obj: int
    scene_capacity: int
    obj_capacity: int
    sh_k: int                # (degree + 1)^2
    c_shs: int               # colour deformation coefficients
    c_xyz: int
    c_rot: int
    c_bg: int
    env_res: int
    frame_num: int


def sizes(spec: dict, capacity_factor: int = 1) -> Sizes:
    """capacity_factor 2: the blocks as the trainer holds them after its
    first densify (a block more than 90% alive is doubled)."""
    n = int(spec["gaussians"])
    n_obj = int(round(n * float(spec["object_share"])))
    n_scene = n - n_obj
    frame_num = scene_frame_num(spec)
    basis = basis_counts(spec["order_args"], frame_num)
    return Sizes(
        n_scene=n_scene, n_obj=n_obj,
        scene_capacity=capacity_factor * round_capacity(n_scene),
        obj_capacity=capacity_factor * round_capacity(n_obj),
        sh_k=(int(spec["sh_degree"]) + 1) ** 2,
        c_shs=param_count(basis["shs"]), c_xyz=param_count(basis["xyz"]),
        c_rot=param_count(basis["rotation"]),
        c_bg=param_count(basis["background"]),
        env_res=int(spec["env_resolution"]), frame_num=frame_num)


def optimization(spec: dict, config_cls):
    """config_cls (an OptimizationConfig) with the fields that the
    configuration's file sets, as the reader's config module sets them."""
    import dataclasses
    return config_cls(**{f.name: spec[f.name]
                         for f in dataclasses.fields(config_cls)
                         if f.name in spec})


def scene_frame_num(spec: dict) -> int:
    """round(1 / frame_gap), frame_gap = cameras / images as the reader
    sets it (nvs-75 and Waymo keep it)."""
    return int(spec["timestamps"])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
LEAVES = ("scene_xyz", "scene_shs_dc", "scene_shs_rest", "scene_scaling",
          "scene_rotation", "scene_opacity", "scene_shs_deform",
          "obj_xyz", "obj_shs_dc", "obj_shs_rest", "obj_scaling",
          "obj_rotation", "obj_opacity", "obj_shs_deform", "xyz_deform",
          "rotation_deform", "gs_time_sigma", "background_deform")


class Cloud(NamedTuple):
    """x ~ U(x0, x0 + length), y ~ N(0, sigma_y), z ~ N(0, sigma_z)."""
    x0: float
    length: float
    sigma_y: float
    sigma_z: float


CLOUDS = {"forward": Cloud(-2.0, 8.0, 4.0, 4.0),
          "surround": Cloud(-8.0, 16.0, 8.0, 4.0)}


def _log_spacing(xyz: torch.Tensor, n_total: int, law: Cloud) -> torch.Tensor:
    """0.5 log of the expected mean 3-NN squared distance at each point of
    the cloud `law` of n_total points (its density rho at the point).
    The sigmas are powers of two, so dividing by them first rounds as
    (y^2 + z^2) / (2 sigma^2) would."""
    pdf = torch.exp(-((xyz[:, 1] / law.sigma_y) ** 2
                      + (xyz[:, 2] / law.sigma_z) ** 2) / 2) \
        / (2 * math.pi * law.sigma_y * law.sigma_z)
    rho = n_total / law.length * pdf
    d2 = KNN3_FACTOR * (4.0 * math.pi * rho / 3.0) ** (-2.0 / 3.0)
    return 0.5 * torch.log(torch.clamp(d2, min=1e-7))


def make_weights(spec: dict, seed: int, device,
                 capacity_factor: int = 1) -> dict:
    """{leaf: tensor} of the model (GaussianParams' fields), plus "env"
    [3, R, R], "scene_alive", "obj_alive" and "gs_time": one normal and
    one uniform draw on `device`, sliced. Dead slots hold zeros, the
    identity quaternion, opacity logit -15 and log-scale -10."""
    sz = sizes(spec, capacity_factor)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ns, no, K = sz.n_scene, sz.n_obj, sz.sh_k
    n = ns + no
    # normal draws, in this order
    layout_n = [("xyz_yz", n * 2), ("shs_rest", n * (K - 1) * 3),
                ("scale", n * 3), ("rot", n * 4), ("opac", n),
                ("shs_deform", n * 3 * sz.c_shs),
                ("xyz_deform", no * 3 * sz.c_xyz),
                ("rot_deform", no * 4 * sz.c_rot),
                ("sigma", no * 2), ("bg", 3 * sz.c_bg)]
    layout_u = [("x", n), ("rgb", n * 3), ("gs_time", no)]
    normal = torch.randn(sum(s for _, s in layout_n), generator=gen,
                         device=device)
    uniform = torch.rand(sum(s for _, s in layout_u), generator=gen,
                         device=device)
    env = torch.randn((3, sz.env_res, sz.env_res), generator=gen,
                      device=device)

    def cut(buf, layout):
        out, at = {}, 0
        for name, size in layout:
            out[name] = buf[at:at + size]
            at += size
        return out

    N, U = cut(normal, layout_n), cut(uniform, layout_u)
    law = CLOUDS[spec.get("cloud", "forward")]
    xyz = torch.stack([U["x"] * law.length + law.x0,
                       N["xyz_yz"][:n] * law.sigma_y,
                       N["xyz_yz"][n:] * law.sigma_z], 1)
    log_s = (_log_spacing(xyz, n, law)[:, None] + math.log(0.3)
             + 0.2 * N["scale"].view(n, 3))
    dc = ((U["rgb"].view(n, 3) - 0.5) / SH_C0)[:, None, :]
    rest = 0.02 * N["shs_rest"].view(n, K - 1, 3)
    rot = N["rot"].view(n, 4)
    opac = (math.log(0.12 / 0.88) + 1.0 * N["opac"]).view(n, 1)
    shs_def = 0.01 * N["shs_deform"].view(n, 3, sz.c_shs)
    frame_gap = 1.0 / sz.frame_num

    def pad(a, cap, fill=0.0):
        out = torch.full((cap,) + tuple(a.shape[1:]), fill,
                         dtype=torch.float32, device=device)
        out[:a.shape[0]] = a
        return out

    def quat_pad(a, cap):
        out = pad(a, cap)
        out[a.shape[0]:, 0] = 1.0
        return out

    Ns, No = sz.scene_capacity, sz.obj_capacity
    s, o = slice(0, ns), slice(ns, n)
    w = dict(
        scene_xyz=pad(xyz[s], Ns), scene_shs_dc=pad(dc[s], Ns),
        scene_shs_rest=pad(rest[s], Ns),
        scene_scaling=pad(log_s[s], Ns, -10.0),
        scene_rotation=quat_pad(rot[s], Ns),
        scene_opacity=pad(opac[s], Ns, -15.0),
        scene_shs_deform=pad(shs_def[s], Ns),
        obj_xyz=pad(xyz[o], No), obj_shs_dc=pad(dc[o], No),
        obj_shs_rest=pad(rest[o], No),
        obj_scaling=pad(log_s[o], No, -10.0),
        obj_rotation=quat_pad(rot[o], No),
        obj_opacity=pad(opac[o], No, -15.0),
        obj_shs_deform=pad(shs_def[o], No),
        xyz_deform=pad(0.05 * N["xyz_deform"].view(no, 3, sz.c_xyz), No),
        rotation_deform=pad(0.05 * N["rot_deform"].view(no, 4, sz.c_rot),
                            No),
        gs_time_sigma=pad(math.log(frame_gap)
                          + 0.3 * N["sigma"].view(no, 2), No),
        background_deform=0.01 * N["bg"].view(1, 3, sz.c_bg),
    )
    w["env"] = env
    w["scene_alive"] = torch.arange(Ns, device=device) < ns
    w["obj_alive"] = torch.arange(No, device=device) < no
    w["gs_time"] = pad(U["gs_time"], No)
    return w


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------
class View(NamedTuple):
    uid: int
    cam_id: int
    R: np.ndarray            # world->camera rotation, used as is
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int
    time: float
    is_test: bool


def rig(spec: dict) -> list:
    """The rig's cameras in reader order (cam_id), each a dict of
    `yaw_deg` (about the vertical axis, + to the left, 0 forward),
    `forward` and `left` (its offset from the rig's origin) and `fx`,
    `fy`, `cx`, `cy` (pixels on the configuration's width x height): the
    configuration's `rig`, or `num_cam` forward cameras `baseline` apart
    to the right at `focal`, the principal point at the centre."""
    n_cam = int(spec["num_cam"])
    if "rig" in spec:
        if len(spec["rig"]) != n_cam:
            raise ValueError(f"{len(spec['rig'])} rig cameras for num_cam "
                             f"{n_cam}")
        return spec["rig"]
    w, h, f = int(spec["width"]), int(spec["height"]), float(spec["focal"])
    return [dict(yaw_deg=0.0, forward=0.0, left=-float(spec["baseline"]) * c,
                 fx=f, fy=f, cx=w / 2, cy=h / 2) for c in range(n_cam)]


def _focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def yawed(yaw_deg: float) -> np.ndarray:
    """World->camera rotation of a camera turned by yaw_deg from HORIZON
    about the vertical axis (+ to the left); HORIZON itself at 0."""
    a = math.radians(yaw_deg)
    c, s = math.cos(a), math.sin(a)
    turn = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return HORIZON @ turn.T


def intrinsics(cam: dict) -> np.ndarray:
    """The camera's 3x3 K, as a flow package carries it."""
    return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                     [0, 0, 1]], np.float32)


def views(spec: dict) -> list:
    """The scene's images in reader order (timestamp-major, camera-minor):
    the rig's origin drives along +x from x = -8, `drive_per_timestamp` a
    timestamp, each camera at its offset from it, turned by its yaw, with
    fovx = focal2fov(fx, 2 cx), fovy = focal2fov(fy, 2 cy) as the port's
    reader turns a K into FoVs, at the configuration's width x height.
    The test split is every `test_every`-th timestamp from the
    `test_every`-th, as the reader's get_val_frames has it."""
    w, h = int(spec["width"]), int(spec["height"])
    cams = [(yawed(float(c["yaw_deg"])), float(c["forward"]),
             float(c["left"]), _focal2fov(float(c["fx"]), 2 * c["cx"]),
             _focal2fov(float(c["fy"]), 2 * c["cy"])) for c in rig(spec)]
    n_t = int(spec["timestamps"])
    every = int(spec["test_every"])
    test = set(range(every, n_t, every))
    out = []
    for i in range(n_t):
        d = float(spec["drive_per_timestamp"]) * i
        for c, (R, forward, left, fovx, fovy) in enumerate(cams):
            centre = np.array([-8.0 + d + forward, left, 0.0])
            out.append(View(uid=len(out), cam_id=c, R=R, T=-R @ centre,
                            fovx=fovx, fovy=fovy, width=w, height=h,
                            time=i / max(n_t - 1, 1), is_test=i in test))
    return out


def cameras_extent(train_views: list) -> float:
    """getNerfppNorm: 1.1 x the largest distance of a camera centre from
    their mean."""
    centres = np.stack([-v.R.T @ v.T for v in train_views])
    return float(1.1 * np.linalg.norm(centres - centres.mean(0),
                                      axis=1).max())


def scene_extent(spec: dict, w: dict) -> float:
    """The norm of the init cloud's bounding box diagonal (the reader's
    scene_extent) over the alive Gaussians."""
    pts = torch.cat([w["scene_xyz"][w["scene_alive"]],
                     w["obj_xyz"][w["obj_alive"]]])
    return float(torch.linalg.vector_norm(pts.max(0).values
                                          - pts.min(0).values))


# ---------------------------------------------------------------------------
# training frames
# ---------------------------------------------------------------------------
def make_frames(spec: dict, seed: int, device, train_views: list,
                flow_per_frame: int, keep=None) -> list:
    """For each training view: (image [3,H,W], inverse-depth prior [H,W],
    sky mask [H,W], object mask [H,W]) on `device`, and its flow
    packages on the host as the reader gives them: [time, K, R, T,
    flow [2,H,W] (target pixel coords), vis [H,W]] in numpy, for the
    views of its camera `flow_per_frame` timestamps around it, each with
    that camera's K. Drawn with a generator seeded with seed + 1, frame by
    frame in view order. With `keep` (a set of indices), the other frames
    are drawn and dropped (None)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    h, w = int(spec["height"]), int(spec["width"])
    Ks = [intrinsics(c) for c in rig(spec)]
    rows = torch.arange(h, device=device, dtype=torch.float32)
    cols = torch.arange(w, device=device, dtype=torch.float32)
    gy, gx = torch.meshgrid(rows, cols, indexing="ij")
    sky_rows = (rows < float(spec["sky_rows_share"]) * h).float()
    by_time = {}
    for v in train_views:
        by_time.setdefault(v.cam_id, []).append(v)
    out = []
    for i, v in enumerate(train_views):
        image = torch.rand((3, h, w), generator=gen, device=device)
        depth = torch.rand((h, w), generator=gen, device=device)
        sky = sky_rows[:, None].expand(h, w).contiguous()
        semantic = (torch.rand((h, w), generator=gen, device=device)
                    < 0.3).float()
        same = by_time[v.cam_id]
        k = same.index(v)
        flows = []
        for step in range(1, flow_per_frame + 1):
            off = (step + 1) // 2 * (1 if step % 2 else -1)
            nb = same[min(max(k + off, 0), len(same) - 1)]
            d = torch.rand((3, h, w), generator=gen, device=device)
            flow = torch.stack([gx + 10.0 * (d[0] - 0.5),
                                gy + 10.0 * (d[1] - 0.5)])
            vis = (d[2] < 0.5).float()
            if keep is not None and i not in keep:
                continue
            flows.append([np.float32(nb.time), Ks[nb.cam_id].copy(),
                          nb.R.astype(np.float32),
                          nb.T.astype(np.float32),
                          flow.cpu().numpy(), vis.cpu().numpy()])
        out.append(((image, depth, sky, semantic), flows)
                   if keep is None or i in keep else None)
    return out

