"""Host-clock ms a window cycle takes: the window's wall over the cycles
it completed (the staleness of every placement)."""


def read(run):
    return 1000.0 * run.wall_s / run.cycles
