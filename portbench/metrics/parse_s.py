"""parse_s (program span): the mean over the window's completed samples of
the program's own `parse` seconds (SampleResult.seconds["parse"]): the
host counter's multi-threaded parse and hash count. None where no sample
has the key: a program without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("parse" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("parse",)) if kept else None
