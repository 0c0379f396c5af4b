"""noise_s (program span): the mean over the window's completed samples of
the program's own `noise` seconds (SampleResult.seconds["noise"]):
the noise scan (`baseline_noise`) over every sequence of the selected
genome, inside call. None where no sample has the key: a program
without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("noise" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("noise",)) if kept else None
