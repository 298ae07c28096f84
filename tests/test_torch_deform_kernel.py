"""Kernels T1 and T2 (csrc/deform.cu) and their plain twins.

On the CPU: the path CPU tensors and `_kernels.plain()` take (`deform`'s
twin: `deformed_package_torch`, and `deformed_xyz` at the flow time),
bitwise the frozen copy of the plain tier (port_bench/reference/plain) in
outputs and gradients, over kitti-75, waymo (no background path), order 1
(kitti-25), a polynomial term (frame_num // 3 where an entry is None), a
vector rotation trajectory added to the base rotation, no time mask and
a quaternion spline with a vector trajectory added, each with and
without a flow time; T2's plain twin (`deform_bwd_torch`)
gives a gradient to exactly the leaves `_reached` names; the orders and
term counts above what the kernels are built for raise.
On the card (the `card` fixture skips them elsewhere; run with
`python -m pytest --noconftest tests/test_torch_deform_kernel.py`): T1
output by output bitwise the plain version's, T2 leaf by leaf within
DEFORM_BWD_GAP of autograd through it, both bitwise on a repeated launch,
one T1 launch a render() and one T2 launch a backward with no host
synchronize, and the raise above the kernels' order. This file imports no
JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from adgs_tpu_torch import _kernels
from chip_smoke import ulps
from adgs_tpu_torch.core.camera import Camera
from adgs_tpu_torch.models import gaussians as gm

KITTI_75 = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
                shs=[0, 0, 0, 6, 0, 0], background=[None, 5, 0, 6, 0, 0])
NO_BG = [0, 0, 0, 0, 0, 0]
# name -> (order arguments, frame_num, use_time_mask)
CONFIGS = {
    "kitti-75": (KITTI_75, 52, True),
    "waymo": (dict(KITTI_75, background=NO_BG), 100, True),
    "order-1": (dict(xyz=[None, 1, 0, 6, 0, 0],
                     rotation=[0, 0, 0, 0, None, 1], shs=[0, 0, 0, 6, 0, 0],
                     background=[None, 1, 0, 6, 0, 0]), 52, True),
    "poly": (dict(xyz=[None, 3, None, 6, 0, 0],
                  rotation=[0, 0, 0, 0, None, 2], shs=[0, 0, 2, 6, 0, 0],
                  background=[None, 5, None, 2, 0, 0]), 100, True),
    "rotation-vector": (dict(KITTI_75, rotation=[None, 3, 0, 6, 0, 0]),
                        52, True),
    "quaternion-and-vector": (dict(KITTI_75, rotation=[None, 2, 0, 3, None,
                                                       4]), 52, True),
    "no-time-mask": (KITTI_75, 52, False),
}
TIMES = (0.0, 0.4137, 1.0)
FLOW_TIME = 0.4329
# T2's largest gap to autograd through the plain version (relative, the
# worst leaf by norm) on the card
DEFORM_BWD_GAP = 1e-5


def model(name, dev="cpu", n=3000, seed=0, quantum=256):
    """A model under one configuration whose trajectories, SH rest,
    rotations, opacities and time sigmas are N(0, 0.3) draws (the 1e-5
    init would hide the splines), with the capacity padding's dead slots,
    a quarter of the object slots with zero rotation trajectories (the
    quaternion chain's small-angle branches) and a quarter whose control
    quaternions have w < 0 (the shortest-arc flip)."""
    orders, frames, mask = CONFIGS[name]
    rng = np.random.default_rng(seed)
    cfg = gm.GaussianConfig.from_order_args(orders, frame_num=frames,
                                            use_time_mask=mask)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    params, state = gm.create_from_pcd(
        pts, rng.uniform(size=(n, 3)).astype(np.float32),
        (rng.random(n) < 0.3).astype(np.float32),
        rng.uniform(size=n).astype(np.float32), cfg,
        np.full(n, 0.01, np.float32), capacity_quantum=quantum, seed=seed,
        device="cpu")
    params = gm.set_init_time_sigma(params, 0.2)
    noisy = {}
    for f in dataclasses.fields(params):
        x = getattr(params, f.name)
        if f.name.endswith(("deform", "rest", "rotation", "opacity",
                            "time_sigma")):
            x = x + torch.as_tensor(rng.normal(0.0, 0.3, x.shape)
                                    .astype(np.float32))
        noisy[f.name] = x
    no = params.obj_capacity
    rd = noisy["rotation_deform"]
    rd[:no // 4] = 0.0
    rd[no // 4:no // 2, 0] = -3.0
    params = dataclasses.replace(params, **noisy)
    move = lambda x: x.to(dev)  # noqa: E731
    return (cfg, dataclasses.replace(params, **{
        f.name: move(getattr(params, f.name))
        for f in dataclasses.fields(params)}),
        dataclasses.replace(state, **{
            f.name: move(getattr(state, f.name))
            for f in dataclasses.fields(state)}))


def frozen_plain():
    from port_bench.reference.plain.models import gaussians as frozen
    return frozen


def leaves_of(params):
    return [getattr(params, k).detach().clone().requires_grad_(True)
            for k in gm.DEFORM_LEAVES]


def with_leaves(params, leaves):
    return dataclasses.replace(params, **dict(zip(gm.DEFORM_LEAVES,
                                                  leaves)))


def cotangents(rng, n, k):
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for s in ((n, 3), (n, 4), (n, k, 3), (n, 1), (n, 3))]


@pytest.mark.parametrize("flow", [False, True])
@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpu_path_bitwise_frozen_plain(name, t, flow):
    """CPU tensors run today's plain version: outputs and gradients bitwise
    the frozen copy's, no kernel launched."""
    frozen = frozen_plain()
    cfg, params, state = model(name)
    k = params.scene_shs_rest.shape[1] + 1
    cots = cotangents(np.random.default_rng(3), params.capacity, k)
    tt = torch.tensor(t)
    ft = torch.tensor(FLOW_TIME) if flow else None
    runs = []
    _kernels.reset_launches()
    for which in ("port", "frozen"):
        xs = leaves_of(params)
        p = with_leaves(params, xs)
        if which == "port":
            pkg, flow_xyz = gm.deform(p, state, cfg, tt, ft)
        else:
            pkg = frozen.deformed_package(p, state, cfg, tt)
            flow_xyz = None if ft is None else frozen.deformed_xyz(p, cfg, ft)
        outs = [pkg["xyz"], pkg["rotation"], pkg["shs"], pkg["opacity"]]
        if flow:
            outs.append(flow_xyz)
        else:
            assert flow_xyz is None
        loss = sum((c * o).sum() for c, o in zip(cots, outs))
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        runs.append((outs, grads))
    (outs, grads), (ref, ref_grads) = runs
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    for leaf, a, b in zip(gm.DEFORM_LEAVES, grads, ref_grads):
        assert (a is None) == (b is None), leaf
        assert a is None or torch.equal(a, b), leaf
    assert _kernels.launches["deform"] == 0
    assert _kernels.launches["deform_bwd"] == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bwd_twin_reaches_what_autograd_reaches(name):
    """deform_bwd_torch gives a gradient to exactly the leaves `_reached`
    names (the leaves T2 writes), None to the others and to the leaves not
    needed."""
    cfg, params, state = model(name)
    leaves = tuple(getattr(params, k) for k in gm.DEFORM_LEAVES)
    k = params.scene_shs_rest.shape[1] + 1
    c = cotangents(np.random.default_rng(4), params.capacity, k)
    grads = [c[0], c[4], c[1], c[2], c[3]]
    needs = [True] * len(leaves)
    got = gm.deform_bwd_torch(cfg, state.gs_time, torch.tensor(0.3),
                              torch.tensor(FLOW_TIME), leaves, grads, needs)
    assert [g is not None for g in got] == list(gm._reached(cfg))
    needs[0] = False
    got = gm.deform_bwd_torch(cfg, state.gs_time, torch.tensor(0.3), None,
                              leaves, [grads[0], None] + grads[2:], needs)
    assert got[0] is None and got[6] is not None


@pytest.mark.parametrize("key, value", [
    ("xyz", [None, 6, 0, 6, 0, 0]), ("rotation", [0, 0, 0, 0, None, 6]),
    ("shs", [0, 0, 129, 0, 0, 0]), ("background", [0, 0, 0, 65, 0, 0])])
def test_basis_args_raise_above_the_kernels(key, value):
    """An order above MAX_ORDER, or more than MAX_TERMS polynomial or
    Fourier terms in one sum, has no kernel: its arguments raise."""
    cfg = gm.GaussianConfig.from_order_args(dict(KITTI_75, **{key: value}),
                                            frame_num=52)
    with pytest.raises(ValueError, match="above the kernels"):
        gm._basis_args(cfg)
    gm._basis_args(gm.GaussianConfig.from_order_args(KITTI_75,
                                                     frame_num=52))


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: T1 and T2 run only there")
    return torch.device("cuda", 0)


def card_case(dev, name, t=0.4137, n=200_000):
    """A model on the card whose scene block ends inside a kernel tile (a
    capacity quantum of 100, the tiles 256 slots)."""
    cfg, params, state = model(name, dev, n=n, quantum=100)
    leaves = tuple(getattr(params, k) for k in gm.DEFORM_LEAVES)
    times = (torch.tensor(t, device=dev), torch.tensor(FLOW_TIME, device=dev))
    return cfg, params, state, leaves, times


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_t1_matches_plain_on_card(card, name, t):
    """T1 output by output (and the flow xyz) bitwise the plain version's;
    a repeated launch bitwise the first."""
    cfg, _, state, leaves, (tt, ft) = card_case(card, name, t)
    _kernels.reset_launches()
    got = gm._deform_fwd(cfg, state.gs_time, tt, ft, leaves)
    again = gm._deform_fwd(cfg, state.gs_time, tt, ft, leaves)
    assert _kernels.launches["deform"] == 2
    want = gm.deform_fwd_torch(cfg, state.gs_time, tt, ft, leaves)
    dist = {i: ulps(a, b) for i, (a, b) in enumerate(zip(got, want))}
    assert not any(dist.values()), dist
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flow", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_t2_matches_autograd_on_card(card, name, flow):
    """T2 leaf by leaf within DEFORM_BWD_GAP of autograd through the plain
    version, a gradient for exactly the leaves it gives one, and a repeated
    launch bitwise the first (the background's two-stage sum)."""
    cfg, params, state, leaves, (tt, ft) = card_case(card, name)
    ft = ft if flow else None
    k = params.scene_shs_rest.shape[1] + 1
    c = [x.to(card) for x in cotangents(np.random.default_rng(5),
                                        params.capacity, k)]
    grads = [c[0], c[4] if flow else None, c[1], c[2], c[3]]
    needs = [True] * len(leaves)
    _kernels.reset_launches()
    got = gm._deform_bwd(cfg, state.gs_time, tt, ft, leaves, grads, needs)
    again = gm._deform_bwd(cfg, state.gs_time, tt, ft, leaves, grads, needs)
    assert _kernels.launches["deform_bwd"] == 2
    want = gm.deform_bwd_torch(cfg, state.gs_time, tt, ft, leaves, grads,
                               needs)
    gaps = {}
    for leaf, a, b, r in zip(gm.DEFORM_LEAVES, got, want, again):
        assert (a is None) == (b is None), leaf
        if a is not None:
            gaps[leaf] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            assert torch.equal(a, r), leaf
    assert max(gaps.values()) <= DEFORM_BWD_GAP, gaps


def test_launches_and_no_sync_on_card(card):
    """A training render (flow time set): one T1 launch, and one T2 launch
    in its backward, under set_sync_debug_mode("error"): no host
    synchronize. A served frame: one T1 launch."""
    from adgs_tpu_torch.render import render
    cfg, params, state = model("kitti-75", card, n=20_000)
    params = dataclasses.replace(params, **{
        f.name: getattr(params, f.name).detach().requires_grad_(True)
        for f in dataclasses.fields(params)})
    cam = Camera.create(R=np.eye(3), T=np.array([0.0, 0.0, 8.0]),
                        fovx=2 * math.atan(1242 / (2 * 721.5377)),
                        fovy=2 * math.atan(375 / (2 * 721.5377)),
                        width=1242, height=375, time=0.4, device=card)
    ft = torch.tensor(FLOW_TIME, device=card)

    def step():
        pkg, flow_xyz = gm.deform(params, state, cfg, cam.time, ft)
        loss = sum(x.sum() for x in pkg.values()) + flow_xyz.sum()
        return torch.autograd.grad(loss, [params.xyz_deform,
                                          params.rotation_deform])

    step()                                      # builds and loads
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _kernels.launches["deform"] == 1
    assert _kernels.launches["deform_bwd"] == 1
    _kernels.reset_launches()
    out = render(cam, params, state, cfg, flow_time=ft)
    assert _kernels.launches["deform"] == 1
    out["render"].sum().backward()
    assert _kernels.launches["deform_bwd"] == 1
    _kernels.reset_launches()
    with torch.no_grad():
        render(cam, params, state, cfg)
    assert _kernels.launches["deform"] == 1
    assert _kernels.launches["deform_bwd"] == 0


def test_raise_above_the_kernels_order_on_card(card):
    """A B-spline of order 6 has no kernel: deform raises for CUDA tensors
    (and the plain version runs it on the CPU)."""
    cfg = gm.GaussianConfig.from_order_args(
        dict(KITTI_75, xyz=[None, 6, 0, 6, 0, 0]), frame_num=52)
    _, params, state = model("kitti-75", "cpu", n=2000)
    params = dataclasses.replace(params, xyz_deform=torch.zeros(
        (params.obj_capacity, 3, cfg.xyz.param_count)))
    gm.deform(params, state, cfg, torch.tensor(0.4))
    on_card = dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(card)
        for f in dataclasses.fields(params)})
    state = dataclasses.replace(state, gs_time=state.gs_time.to(card))
    with pytest.raises(ValueError, match="above the kernels"):
        gm.deform(on_card, state, cfg, torch.tensor(0.4, device=card))
