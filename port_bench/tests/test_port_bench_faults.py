"""The comparison that decides `correct` fails the faults a cell can
have, planted underneath the timed path at the toy size
(port_bench/faults.py): a training step that returns its state
unchanged, one that returns the statistics densify reads unchanged, a
step whose losses leave out half the frame's pixels (the mean over the
rest), a served image altered where it is produced; on the committed
cells and on the three-camera rig (conftest.py RIG)."""

import pytest

from conftest import toy_run


@pytest.mark.parametrize("workload", ("kitti75-train", "waymo-train",
                                      "rig-train"))
@pytest.mark.parametrize("fault", ("unchanged_state", "frozen_statistics",
                                   "half_batch"))
def test_train_fault_is_not_correct(fault, workload):
    from port_bench.faults import planted
    with planted(fault):
        run = toy_run(workload)
    assert not run.correct
    assert [n for n, v, lim in run.checks if not v <= lim]


@pytest.mark.parametrize("workload", ("kitti75-render", "waymo-render",
                                      "rig-render"))
def test_render_altered_answer_is_not_correct(workload):
    from port_bench.faults import planted
    with planted("altered_answer"):
        run = toy_run(workload)
    assert not run.correct
    gap = {n: (v, lim) for n, v, lim in run.checks}["max_pixel_gap"]
    assert gap[0] > gap[1]


def test_faults_are_put_back():
    from adgs_tpu_torch import render
    from adgs_tpu_torch.train import step, trainer
    from port_bench.faults import planted
    before = (render.make_staged_render_fn, step.compute_losses,
              trainer.make_train_step)
    for fault in ("unchanged_state", "frozen_statistics", "half_batch",
                  "altered_answer"):
        with planted(fault):
            pass
    assert before == (render.make_staged_render_fn, step.compute_losses,
                      trainer.make_train_step)
