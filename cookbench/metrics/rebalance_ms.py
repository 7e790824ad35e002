"""Host-clock ms a window cycle spends in `Scheduler.rebalance_cycle`,
summed over pools; nothing where the traffic does not rebalance."""


def read(run):
    if not run.rebalance:
        return None
    return run.mean_wall("rebalance")
