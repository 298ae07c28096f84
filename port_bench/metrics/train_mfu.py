"""The whole training step's share of the chip's peak: the least time the
chip could take for one step's required work (port_bench/roofline.py
train_step_bound, at the alive counts and the profiled frames' pairs)
over the mean ms/step of the traced run's window steps (the profiled
steps come after the window)."""

UNIT = "%"


def read(run):
    if run.data.get("driver") != "train":
        return None
    bound = run.data.get("step_bound_s")
    steps = run.data.get("window_step_s")
    if not bound or not steps:
        return None
    return 100.0 * bound / (sum(steps) / len(steps))
