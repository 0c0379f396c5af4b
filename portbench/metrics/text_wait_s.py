"""text_wait_s (program span): the mean over the window's completed samples
of the program's own `text_wait` seconds
(SampleResult.seconds["text_wait"]): the counting thread blocked on text
another thread inflates. None where no sample has the key: a program
without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("text_wait" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("text_wait",)) if kept else None
