"""Host ms of a training iteration outside the step call and its two host
reads (span "trainer.iteration" less "trainer.step" less "trainer.read"):
camera pick, frames and flow package, logging, KNN refresh, densify;
mean per iteration over the profiled steps after the window."""

from port_bench.program_spans import group, ms

UNIT = "ms"
ROOT = "trainer.iteration"


def read(run):
    spans = group(run, "train", ROOT)
    if spans is None:
        return None
    return ms(spans, ROOT) - ms(spans, "trainer.step") \
        - ms(spans, "trainer.read")
