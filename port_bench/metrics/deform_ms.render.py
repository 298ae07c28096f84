"""Device-timeline ms from a frame's "start" mark to its "preprocess"
mark: the temporal deformation and the EWA preprocess; mean per frame
over the traced run's window frames."""

UNIT = "ms"
STAGES = ("deform", "preprocess")


def read(run):
    if run.data.get("driver") != "render":
        return None
    ms = [sum(m[s] for s in STAGES) for m in run.data.get("stage_marks", [])
          if all(s in m for s in STAGES)]
    return sum(ms) / len(ms) if ms else None
