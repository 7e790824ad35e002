"""The program's own encode wall (`MatchOutcome.phase_wall_s["encode"]`), in ms
a window cycle, summed over pools; the pool-batched pass counts its one
shared stack and solve once."""


def read(run):
    return run.mean_phase("encode")
