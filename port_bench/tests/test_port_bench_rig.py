"""The camera rig and the clouds of port_bench/scene.py.

Configurations without `rig` and `cloud` get bitwise the inputs that the
functions below gave before the rig existed (a frozen copy). A
three-camera rig (tests/conftest.py RIG: yaws 0, +55 and -55 degrees,
three intrinsics, the surround cloud) gives its cameras their own views
and K, in the program's driver and in the plain reference alike, and its
side cameras a share of the work comparable to the front one's."""

import math

import numpy as np
import pytest
import torch

from conftest import RIG, cell_spec, toy_spec
from port_bench import scene

SEEDS = (2 ** 31 + 7, 4_510_000_002)


# ---------------------------------------------------------------------------
# the functions as they were before the rig and the clouds (frozen)
# ---------------------------------------------------------------------------
def _frozen_log_spacing(xyz: torch.Tensor, n_total: int) -> torch.Tensor:
    """0.5 log of the expected mean 3-NN squared distance at each point of
    the cloud x ~ U(-2, 6), y, z ~ N(0, 4) of n_total points."""
    sigma = 4.0
    pdf = torch.exp(-(xyz[:, 1] ** 2 + xyz[:, 2] ** 2) / (2 * sigma ** 2)) \
        / (2 * math.pi * sigma ** 2)
    rho = n_total / 8.0 * pdf
    d2 = scene.KNN3_FACTOR * (4.0 * math.pi * rho / 3.0) ** (-2.0 / 3.0)
    return 0.5 * torch.log(torch.clamp(d2, min=1e-7))


def frozen_make_weights(spec: dict, seed: int, device,
                        capacity_factor: int = 1) -> dict:
    """{leaf: tensor} of the model (GaussianParams' fields), plus "env"
    [3, R, R], "scene_alive", "obj_alive" and "gs_time": one normal and
    one uniform draw on `device`, sliced. Dead slots hold zeros, the
    identity quaternion, opacity logit -15 and log-scale -10."""
    sz = scene.sizes(spec, capacity_factor)
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
    xyz = torch.stack([U["x"] * 8.0 - 2.0,
                       N["xyz_yz"][:n] * 4.0, N["xyz_yz"][n:] * 4.0], 1)
    log_s = (_frozen_log_spacing(xyz, n)[:, None] + math.log(0.3)
             + 0.2 * N["scale"].view(n, 3))
    dc = ((U["rgb"].view(n, 3) - 0.5) / scene.SH_C0)[:, None, :]
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


def frozen_views(spec: dict) -> list:
    """The scene's images in reader order (timestamp-major, camera-minor):
    cameras drive along +x from x = -8, `drive_per_timestamp` a step; the
    second camera of a stereo pair sits `baseline` to the right. The test
    split is every `test_every`-th timestamp from the `test_every`-th, as
    the reader's get_val_frames has it."""
    w, h, f = int(spec["width"]), int(spec["height"]), float(spec["focal"])
    fovx = 2 * math.atan(w / (2 * f))
    fovy = 2 * math.atan(h / (2 * f))
    n_t, n_cam = int(spec["timestamps"]), int(spec["num_cam"])
    every = int(spec["test_every"])
    test = set(range(every, n_t, every))
    out = []
    for i in range(n_t):
        d = float(spec["drive_per_timestamp"]) * i
        for c in range(n_cam):
            centre = np.array([-8.0 + d, -float(spec["baseline"]) * c, 0.0])
            out.append(scene.View(uid=len(out), cam_id=c, R=scene.HORIZON,
                            T=-scene.HORIZON @ centre, fovx=fovx, fovy=fovy,
                            width=w, height=h, time=i / max(n_t - 1, 1),
                            is_test=i in test))
    return out


def frozen_make_frames(spec: dict, seed: int, device, train_views: list,
                       flow_per_frame: int, keep=None) -> list:
    """For each training view: (image [3,H,W], inverse-depth prior [H,W],
    sky mask [H,W], object mask [H,W]) on `device`, and its flow
    packages on the host as the reader gives them: [time, K, R, T,
    flow [2,H,W] (target pixel coords), vis [H,W]] in numpy, for the
    views `flow_per_frame` timestamps around it. Drawn with a generator
    seeded with seed + 1, frame by frame in view order. With `keep` (a set
    of indices), the other frames are drawn and dropped (None)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    h, w = int(spec["height"]), int(spec["width"])
    f = float(spec["focal"])
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
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
            flows.append([np.float32(nb.time), K.copy(),
                          nb.R.astype(np.float32),
                          nb.T.astype(np.float32),
                          flow.cpu().numpy(), vis.cpu().numpy()])
        out.append(((image, depth, sky, semantic), flows)
                   if keep is None or i in keep else None)
    return out


# ---------------------------------------------------------------------------
def _same(a, b) -> bool:
    """Bitwise equality of arrays, tensors, numbers and their lists."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.numpy().tobytes() == b.numpy().tobytes())
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ("kitti75-train", "waymo-train"))
def test_configurations_without_a_rig_keep_their_inputs(workload, seed):
    spec = toy_spec(cell_spec(workload)[1])
    assert "rig" not in spec and "cloud" not in spec
    cpu = torch.device("cpu")
    got, want = scene.views(spec), frozen_views(spec)
    assert _same(got, want)
    train = [v for v in want if not v.is_test]
    keep = set(range(0, len(train), 3))
    for kept in (None, keep):
        a = scene.make_frames(spec, seed, cpu, train, 2, keep=kept)
        b = frozen_make_frames(spec, seed, cpu, train, 2, keep=kept)
        assert _same(a, b)
    a = scene.make_weights(spec, seed, cpu, capacity_factor=2)
    b = frozen_make_weights(spec, seed, cpu, capacity_factor=2)
    assert a.keys() == b.keys()
    assert all(_same(a[k], b[k]) for k in b), \
        [k for k in b if not _same(a[k], b[k])]


def test_toy_rig_keeps_each_camera_fov():
    full = scene.views(dict(cell_spec("rig-train")[1]))
    toy = scene.views(toy_spec(cell_spec("rig-train")[1]))
    n = len(RIG["rig"])
    for v, t in zip(full[:n], toy[:n]):
        cam = RIG["rig"][v.cam_id]
        assert v.fovx == pytest.approx(2 * math.atan(cam["cx"] / cam["fx"]),
                                       rel=1e-12)
        assert v.fovy == pytest.approx(2 * math.atan(cam["cy"] / cam["fy"]),
                                       rel=1e-12)
        assert (t.fovx, t.fovy) == pytest.approx((v.fovx, v.fovy),
                                                 rel=1e-12)
        assert (t.width, t.height) == (64, 48)
        # the camera looks along its yaw, level
        yaw = math.radians(cam["yaw_deg"])
        assert v.R[2] == pytest.approx([math.cos(yaw), math.sin(yaw), 0.0])
        centre = -v.R.T @ v.T
        assert centre == pytest.approx([-8.0 + cam["forward"], cam["left"],
                                        0.0])
    assert len({(v.fovx, v.fovy) for v in full[:n]}) == n


def test_flow_packages_carry_their_cameras_k():
    spec = toy_spec(cell_spec("rig-train")[1])
    train = [v for v in scene.views(spec) if not v.is_test]
    frames = scene.make_frames(spec, SEEDS[0], torch.device("cpu"), train, 2)
    ks = [scene.intrinsics(c) for c in spec["rig"]]
    assert len({k.tobytes() for k in ks}) == len(ks)
    same_cam = {}
    for v in train:
        same_cam.setdefault(v.cam_id, {})[np.float32(v.time)] = v
    for v, (_, flows) in zip(train, frames):
        assert len(flows) == 2
        for t, K, R, T, _, _ in flows:
            nb = same_cam[v.cam_id][t]
            assert _same(K, ks[v.cam_id])
            assert _same(R, nb.R.astype(np.float32))
            assert _same(T, nb.T.astype(np.float32))
            assert K[0, 0] == pytest.approx(
                spec["rig"][v.cam_id]["fx"], rel=1e-6)


def test_side_cameras_render_at_least_half_the_front():
    """Each camera's largest num_rendered over the training views, by the
    program's binning on the toy rig's model."""
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.models.gaussians import (GaussianConfig,
                                                 GaussianParams,
                                                 GaussianState)
    from adgs_tpu_torch.render import compute_binning
    spec = toy_spec(cell_spec("rig-train")[1])
    cpu = torch.device("cpu")
    w = scene.make_weights(spec, SEEDS[0], cpu)
    params = GaussianParams(**{name: w[name] for name in scene.LEAVES})
    zeros = torch.zeros(params.capacity)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros,
        denom=zeros, obj_near_idx=torch.zeros((1, 1), dtype=torch.int32),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool))
    cfg = GaussianConfig.from_order_args(
        spec["order_args"], scene.scene_frame_num(spec), 3,
        sh_degree=int(spec["sh_degree"]), use_time_mask=True)
    by_cam = [0] * len(spec["rig"])
    for v in scene.views(spec):
        if v.is_test:
            continue
        cam = Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                            width=v.width, height=v.height, time=v.time,
                            device=cpu)
        nr = int(compute_binning(cam, params, state, cfg,
                                 capacity=1 << 10).num_rendered)
        by_cam[v.cam_id] = max(by_cam[v.cam_id], nr)
    assert by_cam[0] > 0
    assert min(by_cam[1:]) >= 0.5 * by_cam[0], by_cam


@pytest.mark.parametrize("workload", ("rig-train", "rig-render"))
def test_reference_rebuilds_the_program_views(workload, monkeypatch):
    """Every camera the plain reference builds is one the program's run
    built, to the bit, on the rig."""
    from conftest import toy_run
    from adgs_tpu_torch.core import camera as program
    from port_bench.reference.plain.core import camera as plain
    built = {"program": set(), "reference": set()}

    def record(side, cls):
        create = cls.create.__func__

        def recorded(cls, R, T, fovx, fovy, width, height, time=0.0, **kw):
            built[side].add((np.asarray(R).tobytes(),
                             np.asarray(T).tobytes(), fovx, fovy, width,
                             height, float(time)))
            return create(cls, R, T, fovx, fovy, width, height, time, **kw)
        monkeypatch.setattr(cls, "create", classmethod(recorded))

    record("program", program.Camera)
    record("reference", plain.Camera)
    run = toy_run(workload)
    assert run.correct
    assert built["reference"] and built["reference"] <= built["program"]
    assert len(run.data["max_num_rendered_by_camera"]) == len(RIG["rig"])
