"""merge_s (program span): the mean over the window's completed samples of
the program's own `merge` seconds (SampleResult.seconds["merge"]): the
merge of a mate's parts where the card counts it in parts (the runs of
every part sorted together, summed in int64, capped, floored). None where
no sample has the key: a program without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("merge" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("merge",)) if kept else None
