"""stream_dispatch_ms (program span): the mean over the window's completed
samples of the program's own `dispatch` seconds
(SampleResult.seconds["dispatch"]), in ms: each streamed partition's
upload and pass-1 enqueue, inside count. None where no sample has the key:
a program without that span."""

from portbench.spans import stage_mean


def read(record):
    kept = any("dispatch" in s["seconds"] for c in record["calls"] for s in c["samples"])
    return stage_mean(record, ("dispatch",), 1e3) if kept else None
