"""Host ms of one camera of a served frame: the "render.camera" spans of
make_staged_render_fn's frames (each camera's preprocess, binning,
compositing and sky, enqueued on the frame's one deformed package) over
the cameras the frames render (counter "frame_cameras"), over the
profiled frames after the window. What issuing one camera of a frame
costs the host. None where no frame carries the span or the counter."""

from port_bench.program_spans import counter, group

UNIT = "ms"
ROOT = "serve.frame"
SPAN = "render.camera"


def read(run):
    spans = group(run, "render", ROOT)
    if spans is None or SPAN not in spans:
        return None
    cameras = counter(spans, ROOT, "frame_cameras")
    return spans[SPAN]["ms"] / cameras if cameras else None
