"""Device-timeline ms from the step's "losses" mark to its "backward"
mark (adgs_tpu_torch._stages, recorded inside make_train_step): autograd
through losses, sky, compositing (B4, B5, B8), preprocess and deform;
mean per step over the traced run's window steps."""

UNIT = "ms"
STAGE = "backward"


def read(run):
    if run.data.get("driver") != "train":
        return None
    ms = [m[STAGE] for m in run.data.get("step_marks", []) if STAGE in m]
    return sum(ms) / len(ms) if ms else None
