"""Host ms of the step call (span "trainer.step", entry to return): what
the host needs to issue one training step, the step's own waits for the
card included; mean per iteration over the profiled steps after the
window."""

from port_bench.program_spans import group, ms

UNIT = "ms"


def read(run):
    spans = group(run, "train", "trainer.iteration")
    return None if spans is None else ms(spans, "trainer.step")
