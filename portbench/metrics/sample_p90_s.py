"""sample_p90_s (host clock): the 90th percentile of the wall time of every
call in the window, from run_call's start to its return with the VCF
written: in a cell of lone samples, each sample's turnaround."""

import statistics


def read(record):
    walls = [c["wall_s"] for c in record["calls"]]
    if len(walls) < 2:
        return walls[0] if walls else None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
