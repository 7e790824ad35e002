"""The bytes a match solve needs, counted from its problem as the inputs
need it: each input byte read once, each output byte written once.

For J considered jobs and N hosts: the jobs' demands (mem, cpus, gpus
as float32, 12 J), the hosts' availabilities (12 N) and totals (mem,
cpus, 8 N), the feasibility relation at one bit a pair (J N / 8, rounded
up), and the assignment written back (one int32 a job, 4 J).  Padding,
chunking, rounds and which kernels solve it do not change the count.
"""
from __future__ import annotations


def match_bytes(jobs: int, hosts: int) -> int:
    if jobs <= 0 or hosts <= 0:
        return 0
    return 12 * jobs + 20 * hosts + (jobs * hosts + 7) // 8 + 4 * jobs
