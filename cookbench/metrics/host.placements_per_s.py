"""Tasks launched in the window over the window's wall, on the host
clock."""


def read(run):
    return run.launched / run.wall_s
