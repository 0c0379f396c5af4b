"""inflate_s (program span): the mean over the window's completed samples of
the program's own `inflate` seconds (SampleResult.seconds["inflate"]): the
read and inflate of every mate, on whatever thread ran it. None where no
sample has the key: a program without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("inflate" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("inflate",)) if kept else None
