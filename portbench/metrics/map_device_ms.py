"""map_device_ms (device trace): the device time of every kernel in the
traced calls but the device counter's window packing, per traced sample,
in ms. With the host counter every kernel of a call is the map's: K1,
(b), (d), K2, (c) and the torch ops pass 1 and pass 2 launch."""


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    traced = [s for c in record["calls"] for s in c["samples"] if s["traced"] and s["ok"]]
    secs = sum(v[1] for name, v in tr["kernels"].items() if "pack_windows_kernel" not in name)
    return 1e3 * secs / len(traced) if traced and secs > 0 else None
