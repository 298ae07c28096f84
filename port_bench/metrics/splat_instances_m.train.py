"""Millions of splat instances, the (Gaussian, tile) pairs that size the
expansion, compositing and per-Gaussian reduction kernels, a training
iteration (counter "splat_instances" over the "trainer.iteration" root:
the step's num_rendered, summed over its cameras); mean per iteration
over the profiled steps after the window. None where no root carries the
counter: a program that does not count reads as nothing, never as 0."""

from port_bench.program_spans import group

UNIT = "M"
ROOT = "trainer.iteration"
COUNTER = "splat_instances"


def read(run):
    spans = group(run, "train", ROOT)
    if spans is None:
        return None
    counts = spans[ROOT]["counts"]
    return counts[COUNTER] / 1e6 if COUNTER in counts else None
