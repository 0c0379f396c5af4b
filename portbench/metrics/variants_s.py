"""variants_s (program span): the mean over the window's completed samples of
the program's own `variants` seconds (SampleResult.seconds["variants"]):
the filter cascade (`call_variants_for_seq`) over every sequence of
the selected genome, inside call. None where no sample has the key: a program
without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("variants" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("variants",)) if kept else None
