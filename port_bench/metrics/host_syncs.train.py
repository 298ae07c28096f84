"""Points a training iteration waits for the card (counter "host_syncs"
over the "trainer.iteration" root: the loss and num_rendered reads, the
host-to-card copies from pageable memory, logging's reads, a refresh's);
mean per iteration over the profiled steps after the window."""

from port_bench.program_spans import counter, group

UNIT = "count"
ROOT = "trainer.iteration"


def read(run):
    spans = group(run, "train", ROOT)
    return None if spans is None else counter(spans, ROOT, "host_syncs")
