"""The whole served frame's share of the chip's peak: the least time for
one frame's required work (port_bench/roofline.py render_frame_bound)
over the mean ms/frame of the traced run's window frames (the profiled
frames come after the window)."""

UNIT = "%"


def read(run):
    if run.data.get("driver") != "render":
        return None
    bound = run.data.get("frame_bound_s")
    frames = run.data.get("window_frame_s")
    if not bound or not frames:
        return None
    return 100.0 * bound / (sum(frames) / len(frames))
