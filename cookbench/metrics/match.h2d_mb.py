"""MB a window cycle moves host to device for the match (the program's
data-plane ledger: families node-encode, job-feasibility, hier-coarse,
hier-fine).  A count, so it repeats exactly for a seed."""

FAMILIES = ("node-encode", "job-feasibility", "hier-coarse", "hier-fine")


def read(run):
    if not run.cycles:
        return None
    total = sum(run.h2d_bytes.get(f, 0) for f in FAMILIES)
    return total / run.cycles / 1e6
