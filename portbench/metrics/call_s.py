"""call_s (program span): the mean over the window's completed samples of
the program's own `call` stage seconds (SampleResult.seconds["call"])."""

from portbench.spans import stage_mean


def read(record):
    return stage_mean(record, ("call",))
