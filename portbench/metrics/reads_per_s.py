"""reads_per_s (host clock): the reads of every sample completed in the
window, as generated, over the window's span from the start of its first
call to the end of its last."""


def read(record):
    calls = record["calls"]
    reads = sum(s["reads"] for c in calls for s in c["samples"] if s["ok"])
    span = calls[-1]["t1"] - calls[0]["t0"] if calls else 0.0
    return reads / span if reads and span > 0 else None
