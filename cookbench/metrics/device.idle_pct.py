"""Share of the window in which no operation ran on the card: one less
the union of the device-busy intervals (kernels, copies, sets) over the
traced window, from `torch.profiler`."""


def read(run):
    if run.timeline is None:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s() / run.timeline.window_s)
