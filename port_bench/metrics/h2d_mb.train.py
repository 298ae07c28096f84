"""Megabytes (10^6 B) the program copies from host memory to the card a
training iteration (counter "h2d_bytes" over the "trainer.iteration"
root: the flow package, flow_valid, the step's small constants, a
refresh's); mean per iteration over the profiled steps after the
window."""

from port_bench.program_spans import counter, group

UNIT = "MB"
ROOT = "trainer.iteration"


def read(run):
    spans = group(run, "train", ROOT)
    return None if spans is None else counter(spans, ROOT, "h2d_bytes") / 1e6
