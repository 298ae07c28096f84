"""Host ms of a densify event (span "trainer.densify": the densify, the
capacity check and any growth ("trainer.grow"), the KNN refresh after
it), mean over the events among the profiled steps after the window of
the densify traffic (drivers/train_densify.py, which puts a densify
there); None where they hold none. The program's densify and growth
counters over those steps, and its "trainer.grow" spans, go to standard
error beside it."""

import sys

UNIT = "ms"
SPAN = "trainer.densify"
COUNTERS = ("densify_cloned", "densify_split", "densify_pruned",
            "densify_dropped", "capacity_grows")


def read(run):
    # the densify traffic's alone: another train cell's profiled steps
    # may hold a densify too, which its window does not measure
    if run.traffic.get("driver") != "train_densify":
        return None
    from adgs_tpu_torch import profiling
    roots = getattr(profiling, "roots", None)
    if roots is None:
        return None
    spans = [s for r in roots() if r.name == "trainer.iteration"
             for s in r.walk()]
    events = [s for s in spans if s.name == SPAN]
    if not events:
        return None
    value = sum(s.ms for s in events) / len(events)
    counts = {}
    for s in spans:
        for k, v in (s.counts or {}).items():
            if k in COUNTERS:
                counts[k] = counts.get(k, 0) + v
    grows = sum(1 for s in spans if s.name == "trainer.grow")
    print(f"densify_ms.train: {value!r} ms over {len(events)} densify "
          f"events; counters over the profiled steps {counts}; "
          f"trainer.grow spans {grows}", file=sys.stderr)
    return value
