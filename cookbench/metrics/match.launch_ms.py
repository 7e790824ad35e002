"""The program's own launch wall (`MatchOutcome.phase_wall_s["launch"]`), in ms
a window cycle, summed over pools; the pool-batched pass counts its one
shared stack and solve once."""


def read(run):
    return run.mean_phase("launch")
