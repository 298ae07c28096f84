"""Device-timeline ms from the step's "backward" mark to its "adam" mark:
the per-leaf Adam update of every parameter and the sky; mean per step
over the traced run's window steps."""

UNIT = "ms"
STAGE = "adam"


def read(run):
    if run.data.get("driver") != "train":
        return None
    ms = [m[STAGE] for m in run.data.get("step_marks", []) if STAGE in m]
    return sum(ms) / len(ms) if ms else None
