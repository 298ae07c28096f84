"""The device's idle share of the profiled sub-window of a train run: one
minus the union of the CUDA kernels, copies and sets in the trace over
the sub-window's length."""

UNIT = "%"
DRIVER = "train"


def read(run):
    if run.data.get("driver") != DRIVER:
        return None
    tr = run.data.get("trace") or {}
    if not tr.get("window_s") or not tr.get("device_events"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
