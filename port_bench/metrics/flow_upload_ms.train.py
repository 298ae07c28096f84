"""Host ms of the trainer's frames for a step (span "trainer.frames"):
the frame cache, the flow package's copies to the card and their
synchronizes, the zero package; mean per iteration over the profiled
steps after the window."""

from port_bench.program_spans import group, ms

UNIT = "ms"


def read(run):
    spans = group(run, "train", "trainer.iteration")
    return None if spans is None else ms(spans, "trainer.frames")
