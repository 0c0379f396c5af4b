"""write_s (program span): the mean over the window's completed samples of
the program's own `write` seconds (SampleResult.seconds["write"]):
the writers, the VCF and the pileup where --pileup asks for it,
inside call. None where no sample has the key: a program
without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("write" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("write",)) if kept else None
