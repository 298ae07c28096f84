"""Host ms of a served frame's call (root span "serve.frame" of
make_staged_render_fn's function): what the host needs to issue one
frame, its own waits for the card included, the image's copy to the host
not; mean per frame over the profiled frames after the window."""

from port_bench.program_spans import group, ms

UNIT = "ms"
ROOT = "serve.frame"


def read(run):
    spans = group(run, "render", ROOT)
    return None if spans is None else ms(spans, ROOT)
