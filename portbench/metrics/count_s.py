"""count_s (program span): the mean over the window's completed samples of
the program's own `count` stage seconds (SampleResult.seconds["count"])."""

from portbench.spans import stage_mean


def read(record):
    return stage_mean(record, ("count",))
