"""setup_s (host clock): process start to the first measured call, less
the time spent making or finding the inputs: imports, the card, the
kernel and native libraries, the index read or built, the warm calls."""


def read(record):
    return record["setup_s"]
