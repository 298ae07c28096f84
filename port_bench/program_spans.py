"""What the program's own spans and counters say (adgs_tpu_torch.profiling,
recorded only while a profiler runs: in a traced run, the profiled
sub-window after the window, its iterations or frames each one root). A
root is kept only if the profiler outlives it, so a train cell's summary
holds the profiled steps but the last, inside whose step the train
traffic stops its profiler; a render cell's holds every profiled frame. A
program without spans reads as nothing, and so does a store that holds
no root of the asked name."""

from __future__ import annotations


def group(run, traffic: str, root: str):
    """{span name: {"ms", "self_ms", "counts"}} per root of `root` in the
    program's span summary, or None (a run of another traffic, no such
    root, or a program without spans)."""
    if run.data.get("driver") != traffic:
        return None
    from adgs_tpu_torch import profiling
    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    g = summary().get(root)
    return g["spans"] if g and g["roots"] else None


def ms(spans: dict, name: str) -> float:
    """Host ms per root of the spans `name` (0 where none ran)."""
    return spans[name]["ms"] if name in spans else 0.0


def counter(spans: dict, root: str, name: str) -> float:
    """A counter per root, over every span of the root."""
    return spans[root]["counts"].get(name, 0.0)
