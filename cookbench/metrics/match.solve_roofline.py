"""The match solve's share of its roofline: the least time the card
needs for the window's solve work (`work.match_bytes` of every pool's
problem of every cycle, at the card's published HBM bandwidth) over the
device time (the union of the intervals) of every kernel launched inside
the benchmark's `bench.match` spans.  Bytes bound it: the work has no
arithmetic to speak of."""
from cookbench.metrics import work
from cookbench.trace import union_seconds


def read(run):
    if run.timeline is None or run.peak is None:
        return None
    kernels = [(s, e) for s, e, _, cat, _ in run.timeline.launched_in(
        "bench.match") if cat == "kernel"]
    busy = union_seconds(kernels) / 1e6
    need = sum(work.match_bytes(j, n) for j, n in run.problems)
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * need / run.peak["hbm_bytes_per_s"] / busy
