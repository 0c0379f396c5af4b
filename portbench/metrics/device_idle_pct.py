"""device_idle_pct (device trace): 100 x (1 - the union of the device's
kernel, copy and fill intervals / the traced window)."""


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
