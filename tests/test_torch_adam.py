"""The port's one-launch Adam (adgs_tpu_torch/train/optim.py, kernel
csrc/adam.cu) on the CPU: the leaf table its wrapper builds (chunk prefix
sums, float4 body and scalar tail, leaves() order, rejected leaves), the
plain twin bitwise the eager formula it replaced, and the sharded update's
contiguous slices bitwise adam_update. The kernel itself runs only on the
card (chip_smoke.py's Adam phase holds it bitwise to the twin there)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from adgs_tpu_torch import _kernels
from adgs_tpu_torch.parallel import shard
from adgs_tpu_torch.train import optim as topt
from adgs_tpu_torch.train.config import OptimizationConfig

CHUNK = topt.ADAM_CHUNK


def _group(n, **kw):
    """(p, g, m, v, p', m', v') of n floats."""
    return tuple(torch.zeros(n, **kw) for _ in range(7))


def _tiny_state(seed=0, cap=64, env_res=8):
    """A TrainableState of random leaves at GaussianParams' shapes."""
    from adgs_tpu_torch.models.env_map import EnvironmentMap
    from adgs_tpu_torch.models.gaussians import GaussianParams
    gen = torch.Generator().manual_seed(seed)
    shapes = dict(
        scene_xyz=(cap, 3), scene_shs_dc=(cap, 1, 3),
        scene_shs_rest=(cap, 15, 3), scene_scaling=(cap, 3),
        scene_rotation=(cap, 4), scene_opacity=(cap, 1),
        scene_shs_deform=(cap, 3, 12), obj_xyz=(cap, 3),
        obj_shs_dc=(cap, 1, 3), obj_shs_rest=(cap, 15, 3),
        obj_scaling=(cap, 3), obj_rotation=(cap, 4), obj_opacity=(cap, 1),
        obj_shs_deform=(cap, 3, 12), xyz_deform=(cap, 3, 29),
        rotation_deform=(cap, 4, 17), gs_time_sigma=(cap, 2),
        background_deform=(1, 3, 29))
    g = GaussianParams(**{k: torch.randn(s, generator=gen)
                          for k, s in shapes.items()})
    env = EnvironmentMap(grid=torch.randn((3, env_res, env_res),
                                          generator=gen))
    return topt.TrainableState(gaussians=g, env=env)


def _rand_like(tree, gen, square=False):
    out = [torch.randn(x.shape, generator=gen) for x in topt.leaves(tree)]
    return topt.from_leaves(tree, [x * x for x in out] if square else out)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4 * 4096 + 1, 2 * CHUNK + 7])
def test_adam_table_body_and_tail(n):
    """A leaf of n floats: n // 4 float4s, n % 4 floats alone, ceil(n /
    ADAM_CHUNK) chunks; the leaves after it start where its chunks end."""
    table = topt.adam_table([_group(5), _group(n), _group(CHUNK + 1)],
                            [0.1, 0.2, 0.3])
    mid = -(-n // CHUNK)
    np.testing.assert_array_equal(
        table.sizes, [[5, 1, 0], [n, n // 4, 1], [CHUNK + 1, CHUNK // 4,
                                                   1 + mid]])
    assert table.chunks == 1 + mid + 2
    assert table.lr.dtype == np.float32
    np.testing.assert_array_equal(table.lr, np.float32([0.1, 0.2, 0.3]))


def test_adam_table_unaligned_leaf_goes_alone():
    """A leaf with a pointer off 16 bytes has no float4 body."""
    base = torch.zeros(41)
    grp = (base[1:],) + _group(40)[1:]
    table = topt.adam_table([grp, _group(40)], [1.0, 1.0])
    np.testing.assert_array_equal(table.sizes, [[40, 0, 0], [40, 10, 1]])
    assert table.ptrs[0, 0] == base.data_ptr() + 4


def test_adam_table_follows_leaves_order():
    """19 rows in leaves() order: the 18 Gaussian fields, then the sky;
    each row's seven pointers are p, g, m, v, p', m', v'."""
    tr = _tiny_state()
    gen = torch.Generator().manual_seed(1)
    trees = [tr] + [_rand_like(tr, gen) for _ in range(6)]
    groups = list(zip(*[topt.leaves(t) for t in trees]))
    table = topt.adam_table(groups, topt.leaves(
        topt.lr_tree(OptimizationConfig(), 20.0, 10.0, 100)))
    assert table.sizes.shape == (19, 3) and table.ptrs.shape == (19, 7)
    for i, grp in enumerate(groups):
        assert table.sizes[i, 0] == grp[0].numel()
        assert list(table.ptrs[i]) == [t.data_ptr() for t in grp]
    assert table.sizes[-1, 0] == tr.env.grid.numel()
    assert table.sizes[17, 0] == tr.gaussians.background_deform.numel()
    starts = np.concatenate([[0], np.cumsum(-(-table.sizes[:, 0] // CHUNK))])
    np.testing.assert_array_equal(table.sizes[:, 2], starts[:-1])
    assert table.chunks == starts[-1]


@pytest.mark.parametrize("bad", ["strided", "float64", "shape"])
def test_adam_table_rejects(bad):
    grp = list(_group(12))
    if bad == "strided":
        grp[1] = torch.zeros(24)[::2]
    elif bad == "float64":
        grp[2] = torch.zeros(12, dtype=torch.float64)
    else:
        grp[3] = torch.zeros(13)
    with pytest.raises(ValueError, match="leaf 1"):
        topt.adam_table([_group(4), tuple(grp)], [1.0, 1.0])


def test_adam_table_rejects_too_many_leaves():
    with pytest.raises(ValueError, match="at most"):
        topt.adam_table([_group(1)] * (topt.ADAM_MAX_LEAVES + 1),
                        [1.0] * (topt.ADAM_MAX_LEAVES + 1))


def test_adam_scalars():
    """The kernel's constants: the Python floats rounded to float32, and the
    float32 reciprocals of the bias corrections."""
    _, bc1, bc2 = topt.next_count(torch.tensor(6, dtype=torch.int32))
    s = topt.adam_scalars(bc1, bc2)
    assert s.dtype == np.float32
    np.testing.assert_array_equal(s[[0, 1, 2, 3, 6]], np.float32(
        [0.9, 0.1, 0.999, 0.001, 1e-15]))
    assert s[4] == np.float32(1) / bc1.numpy()
    assert s[5] == np.float32(1) / bc2.numpy()


def test_adam_update_rejects_mixed_devices(monkeypatch):
    """On the kernel's path every leaf has to be on the first one's
    device, checked before anything is built or launched."""
    monkeypatch.setattr(_kernels, "use", lambda t: True)
    tr = _tiny_state()
    meta = topt.from_leaves(tr, [x.to("meta") for x in topt.leaves(tr)])
    st = topt.init_adam(tr)
    with pytest.raises(ValueError, match="expected tensors on meta"):
        topt.adam_update(meta, tr, st, topt.lr_tree(
            OptimizationConfig(), 20.0, 10.0, 5))


def _former_adam(trainables, grads, opt_state, lrs):
    """The eager update as it stood before the kernel."""
    count = opt_state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.as_tensor(0.9, dtype=torch.float32), c)
    bc2 = 1.0 - torch.pow(torch.as_tensor(0.999, dtype=torch.float32), c)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(topt.leaves(trainables), topt.leaves(grads),
                              topt.leaves(opt_state.m),
                              topt.leaves(opt_state.v), topt.leaves(lrs)):
        m = 0.9 * m + (1 - 0.9) * g
        v = 0.999 * v + (1 - 0.999) * (g * g)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-15)
        new_p.append(p - step)
        new_m.append(m)
        new_v.append(v)
    return (topt.from_leaves(trainables, new_p),
            topt.AdamState(m=topt.from_leaves(trainables, new_m),
                           v=topt.from_leaves(trainables, new_v),
                           count=count))


def test_adam_update_cpu_bitwise_former_formula():
    tr = _tiny_state(seed=2)
    gen = torch.Generator().manual_seed(3)
    got, want = (tr, topt.init_adam(tr)), (tr, topt.init_adam(tr))
    opt = OptimizationConfig()
    for it in (1, 2, 3):
        grads = _rand_like(tr, gen)
        lrs = topt.lr_tree(opt, 20.0, 10.0, it)
        got = topt.adam_update(got[0], grads, got[1], lrs)
        want = _former_adam(want[0], grads, want[1], lrs)
    assert int(got[1].count) == int(want[1].count) == 3
    for a, b in zip(topt.leaves(got[0]) + topt.leaves(got[1].m)
                    + topt.leaves(got[1].v),
                    topt.leaves(want[0]) + topt.leaves(want[1].m)
                    + topt.leaves(want[1].v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adam_update_contiguous_slices(monkeypatch, world):
    """sharded_adam_update with its collective replaced by the other ranks'
    slices, one process: every leaf it hands adam_update is contiguous
    (the sky's rows are split on axis 1), and the reassembled update is
    bitwise adam_update's."""
    tr = _tiny_state(seed=4, cap=64, env_res=8)
    gen = torch.Generator().manual_seed(5)
    grads = _rand_like(tr, gen)
    st = topt.AdamState(m=_rand_like(tr, gen),
                        v=_rand_like(tr, gen, square=True),
                        count=torch.tensor(3, dtype=torch.int32))
    lrs = topt.lr_tree(OptimizationConfig(), 10.0, 10.0, 700)
    seen = []

    def adam_update(t, g, s, lr):
        seen.extend(x.is_contiguous() for tree in (t, g, s.m, s.v)
                    for x in topt.leaves(tree))
        return topt.adam_update(t, g, s, lr)

    monkeypatch.setattr(shard, "adam_update", adam_update)
    flats = {}

    def keep(flat, group):
        flats[rank] = flat.clone()
        return torch.zeros((world,) + tuple(flat.shape))

    for rank in range(world):
        monkeypatch.setattr(shard.cc, "gather_nograd", keep)
        shard.sharded_adam_update(tr, grads, st, lrs,
                                  types.SimpleNamespace(size=world, rank=rank))
    monkeypatch.setattr(shard.cc, "gather_nograd", lambda flat, group:
                        torch.stack([flats[r] for r in range(world)]))
    got_t, got_s = shard.sharded_adam_update(
        tr, grads, st, lrs, types.SimpleNamespace(size=world, rank=0))
    assert seen and all(seen)
    want_t, want_s = topt.adam_update(tr, grads, st, lrs)
    assert int(got_s.count) == int(want_s.count)
    for a, b in zip(topt.leaves(got_t) + topt.leaves(got_s.m)
                    + topt.leaves(got_s.v),
                    topt.leaves(want_t) + topt.leaves(want_s.m)
                    + topt.leaves(want_s.v)):
        assert torch.equal(a, b)
