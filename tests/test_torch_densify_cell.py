"""The committed `kitti75-densify` cell (port_bench/workloads/kitti75-densify.json
on port_bench/configs/kitti-75-densify.json, traffic train-densify, driver
port_bench/drivers/train_densify.py) on the CPU:

  - the port's densify_and_prune against the frozen plain copy
    (port_bench/reference/plain/train/densify.py) on the same draws, made
    again from the generator's state as the driver makes them, on blocks
    where clones, split samples, prunes and dropped copies are all
    non-zero: every output bitwise, densify_gap 0; a fault planted in the
    program's outputs (a new slot's moment not zeroed, an alive bit, a
    count) is caught by densify_gap;
  - the driver on port_bench/tests/conftest.py's toy configuration, with
    a densify every 4 iterations and one in the window, its window closed
    after 4 steps: `correct`, densify_gap 0, densify_stalled 0, growth in
    the window, and the densify after the window kept."""

import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from adgs_tpu_torch.models.gaussians import GaussianState
from adgs_tpu_torch.train import densify as tdensify
from adgs_tpu_torch.train.optim import AdamState, TrainableState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "kitti75-densify"
SEED = 4_230_000_017


def _toy():
    """port_bench/tests/conftest.py as a module of its own name (this
    suite has a conftest of its own)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_toy", os.path.join(ROOT, "port_bench", "tests",
                                       "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blocks(seed: int):
    """The benchmark's model at 7,000 Gaussians (blocks of 8,192 and
    4,096 slots, 70% and 51% alive) with N(0, 1e-3) moments, view-space
    gradients U(0, 1e-3) on every slot seen (denom 0 on a tenth), and the
    densify's arguments: a threshold of 1e-4, extents at which about half
    of each block is large, min_opacity 0.05 (about a sixth of the
    opacities below it), prune_big."""
    from port_bench import harness, scene
    toy = _toy()
    spec = dict(toy.toy_spec(harness.cell_files(CELL)[1]), gaussians=7000)
    w = scene.make_weights(spec, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed)
    from adgs_tpu_torch.models.env_map import EnvironmentMap
    from adgs_tpu_torch.models.gaussians import GaussianParams
    params = GaussianParams(**{n: w[n] for n in scene.LEAVES})
    env = EnvironmentMap(grid=w["env"])

    def moments(absolute):
        def draw(x):
            m = 1e-3 * torch.randn(x.shape, generator=g)
            return m.abs() if absolute else m
        return TrainableState(
            dataclasses.replace(params, **{
                f.name: draw(getattr(params, f.name))
                for f in dataclasses.fields(params)}),
            EnvironmentMap(grid=draw(env.grid)))

    opt_state = AdamState(m=moments(False), v=moments(True),
                          count=torch.tensor(5400, dtype=torch.int32))
    n = params.capacity
    denom = (torch.rand(n, generator=g) > 0.1).float() * 3.0
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=torch.rand(n, generator=g),
        xyz_grad_accum=denom * 1e-3 * torch.rand(n, generator=g),
        denom=denom,
        obj_near_idx=torch.zeros((4, 3), dtype=torch.int32),
        obj_near_valid=torch.ones((4,), dtype=torch.bool))

    def half_large(prefix, alive):
        s = torch.exp(getattr(params, f"{prefix}_scaling")).amax(-1)
        return float(s[alive].median()) / 0.01

    args = (1e-4, 1e-4, 0.05, True,
            half_large("scene", state.scene_alive),
            half_large("obj", state.obj_alive), 0.01)
    return TrainableState(params, env), opt_state, state, args


def _plant(got: dict, fault: str) -> dict:
    """A copy of densify_outputs' dict with one fault planted."""
    values, exact = dict(got["values"]), dict(got["exact"])
    counts = list(got["counts"])
    if fault == "moment":
        # a new object slot's first moment left at its source's value
        # in place of zero: the largest moment of the block
        born = exact["obj_alive"] & (values["m.obj_xyz"].abs()
                                     .sum((1,)) == 0)
        slot = int(torch.nonzero(born)[0, 0])
        m = values["m.obj_xyz"].clone()
        m[slot] = m.abs().max()
        values["m.obj_xyz"] = m
    elif fault == "alive":
        a = exact["scene_alive"].clone()
        a[int(torch.nonzero(~a)[0, 0])] = True
        exact["scene_alive"] = a
    elif fault == "count":
        counts[0] += 1
    return dict(values=values, exact=exact, counts=counts)


@pytest.mark.parametrize("fault", [None, "moment", "alive", "count"])
def test_densify_matches_the_frozen_copy(fault):
    from port_bench import harness
    from port_bench.drivers import train_densify as drv
    trainables, opt_state, state, args = _blocks(SEED)
    gen = torch.Generator().manual_seed(SEED)
    kept = dict(inputs=(trainables, opt_state, state),
                gen_state=gen.get_state(), args=args)
    got = drv.densify_outputs(*tdensify.densify_and_prune(
        trainables, opt_state, state, gen, *args))
    ref = drv.plain_densify(kept)
    n = dict(zip(tdensify.DensifyReport._fields, got["counts"]))
    for what in ("cloned", "split", "pruned", "dropped"):
        assert n[f"scene_{what}"] > 0 and n[f"obj_{what}"] > 0, n
    limit = harness.cell_files(CELL)[0]["limits"]["densify_gap"]
    if fault is None:
        assert got["counts"] == ref["counts"]
        for part in ("values", "exact"):
            assert set(got[part]) == set(ref[part])
            for name, r in ref[part].items():
                assert torch.equal(got[part][name], r), name
        assert drv.densify_gap(got, ref) == 0.0
        return
    gap = drv.densify_gap(_plant(got, fault), ref)
    assert gap > limit
    assert math.isinf(gap) == (fault != "moment")


def test_toy_run_is_correct_and_grows():
    """The driver on the toy configuration at a threshold that grows it
    (1e-4, ~2.5% a densify at this size), densifying every 4 iterations
    from 100: checks 101-103, warm-up 104-105, the window 106-109 (a
    densify at 108), then on to the kept densify at 112 and the checked
    step at 113. Two threads."""
    from port_bench import harness
    toy = _toy()
    _, full, _ = harness.cell_files(CELL)
    spec = dict(toy.toy_spec(full), densification_interval=4,
                densify_scene_grad_threshold=1e-4,
                densify_obj_grad_threshold=1e-4)
    traffic = dict(toy.TOY_TRAFFIC["train"], start_iteration=100,
                   window_steps=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        import time
        run = harness.Run(CELL, SEED, 60.0, False, torch.device("cpu"),
                          time.perf_counter(),
                          overrides=dict(spec=spec, traffic=traffic))
        try:
            harness.drive(run)
        finally:
            run.close()
    finally:
        torch.set_num_threads(threads)
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(run.cell["limits"])
    assert line["checks"]["densify_gap"]["value"] == 0.0
    assert line["checks"]["densify_stalled"]["value"] == 0.0
    assert run.data["window_steps"] == 4
    assert run.data["window_densifies"] == 1
    rows = run.data["readings"]["densify"]
    assert [(r["iteration"], r["in_window"]) for r in rows] == \
        [(104, False), (108, True), (112, False)]
    assert all(r["alive_after"] > r["alive_before"] for r in rows)
    assert all(r["cloned"] + r["split"] > 0 for r in rows)
