"""Deformations a served camera costs: the counter "frame_deforms" over
the counter "frame_cameras" of make_staged_render_fn's frames, across the
profiled frames after the window. 1 where each frame is one camera; 1/3
where a frame is a rig of three cameras at one time, deformed once. A
change that deforms once a camera again reads 1 there. None where no
frame carries the counters."""

from port_bench.program_spans import counter, group

UNIT = "count"
ROOT = "serve.frame"


def read(run):
    spans = group(run, "render", ROOT)
    if spans is None:
        return None
    cameras = counter(spans, ROOT, "frame_cameras")
    return counter(spans, ROOT, "frame_deforms") / cameras if cameras \
        else None
