"""Host-clock ms a window cycle spends in `Scheduler.rank_cycle`, summed
over pools."""


def read(run):
    return run.mean_wall("rank")
