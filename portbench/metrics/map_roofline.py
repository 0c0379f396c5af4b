"""map_roofline (device trace): the map kernels' share of the card's
memory roofline over the traced samples, in %: the least time of the
bytes they need (portbench/roofline.py, from the reference's counts) over
the time the kernels took. A share above 100% means a count is wrong: the
run fails rather than print it."""

from portbench import roofline


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    samples = [(record["work"][s["id"]], tuple(s["path"]))
               for c in record["calls"] for s in c["samples"] if s["traced"] and s["ok"]]
    if not samples:
        return None
    ix = record["index"]
    pct, detail = roofline.share(samples, roofline.kernel_seconds(tr["kernels"]),
                                 ix["k"], ix["J"], ix["G"])
    if pct is not None and pct > 100.0:
        raise roofline.OverRoofline(f"map_roofline reads {pct}% (kernels: {detail})")
    return pct
