"""count_wait_s (program span): the mean over the window's completed samples
of the program's own `count_wait` seconds
(SampleResult.seconds["count_wait"]): the main thread blocked on the
sample's count. None where no sample has the key: a program without that
span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("count_wait" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("count_wait",)) if kept else None
