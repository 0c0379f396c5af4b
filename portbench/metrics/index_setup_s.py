"""index_setup_s (host clock): the index read or built until the device
index is ready, the device synchronised, inside set-up."""


def read(record):
    return record["index_setup_s"]
