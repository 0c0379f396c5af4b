"""The program's own stage spans (SampleResult.seconds) as the metrics
read them."""


def stage_mean(record, stages, scale=1.0):
    """The mean over the window's completed samples of the sum of `stages`,
    times `scale`; None without a completed sample."""
    vals = [sum(s["seconds"].get(k, 0.0) for k in stages)
            for c in record["calls"] for s in c["samples"] if s["ok"]]
    return scale * sum(vals) / len(vals) if vals else None
