"""Device-timeline ms from a frame's "binning" mark to its "compositing"
mark: packing the rows and B3; mean per frame over the traced run's
window frames."""

UNIT = "ms"
STAGE = "compositing"


def read(run):
    if run.data.get("driver") != "render":
        return None
    ms = [m[STAGE] for m in run.data.get("stage_marks", []) if STAGE in m]
    return sum(ms) / len(ms) if ms else None
