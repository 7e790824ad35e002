"""Host-clock ms a window cycle spends in the store: submitting its
arrivals and flushing the completions due (the store's event fan-out to
the columnar index, the encode cache and the scheduler)."""


def read(run):
    return run.mean_wall("submit")
