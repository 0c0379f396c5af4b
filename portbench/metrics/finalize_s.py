"""finalize_s (program span): the mean over the window's completed samples of
the program's own `finalize` seconds (SampleResult.seconds["finalize"]):
the host counter's merge, sort and extract (every streamed partition; a
pair's concatenation). None where no sample has the key: a program without
that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("finalize" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("finalize",)) if kept else None
