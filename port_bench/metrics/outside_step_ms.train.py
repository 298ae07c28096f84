"""Host ms of each window iteration outside the step call: camera pick,
the flow package's transfer, logging, the overflow guard, KNN refresh and
densify (the trainer's own loop), between the benchmark's step wrapper's
return and its next call; mean over the traced run's window steps."""

UNIT = "ms"


def read(run):
    gaps = run.data.get("outside_step_s") if run.data.get("driver") \
        == "train" else None
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
