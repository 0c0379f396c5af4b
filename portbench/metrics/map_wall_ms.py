"""map_wall_ms (program span): the mean over the window's completed
samples of the program's h2d + pass1 + pass2 + d2h stage seconds, in ms:
the host's view of the map, enqueue included."""

from portbench.spans import stage_mean


def read(record):
    return stage_mean(record, ("h2d", "pass1", "pass2", "d2h"), 1e3)
