"""The traffic generator: one seed, one set of jobs."""
from __future__ import annotations

import numpy as np
import pytest

from cookbench import deploy
from cookbench.traffic import generator

CASES = [("cook-1pool-10k", "backlog"), ("cook-8pool-10k", "backlog"),
         ("cook-1pool-10k", "preempt")]


def arrivals(config_name, traffic, seed, cycles=3, launched=7):
    cfg = deploy.rehearsal(deploy.load_config(config_name))
    t = generator.Traffic(generator.load(traffic), cfg, seed)
    out = []
    for c in range(cycles):
        got = t.due((c + 1) * t.cycle_ms,
                    {p["name"]: launched for p in cfg["pools"]} if c else None)
        out.append([(a.uuid, a.user, a.pool, a.mem, a.cpus, a.gpus,
                     a.priority, a.runtime_ms) for a in got])
    return out


@pytest.mark.parametrize("config_name,traffic", CASES)
def test_same_seed_same_jobs(config_name, traffic):
    seed = 2**31 + 12345
    assert arrivals(config_name, traffic, seed) == arrivals(
        config_name, traffic, seed)


@pytest.mark.parametrize("config_name,traffic", CASES)
def test_other_seed_other_jobs(config_name, traffic):
    a = arrivals(config_name, traffic, 1)
    b = arrivals(config_name, traffic, 2)
    assert [len(c) for c in a] == [len(c) for c in b]
    assert a != b


def test_backlog_refills_what_launched():
    cfg = deploy.rehearsal(deploy.load_config("cook-8pool-10k"))
    t = generator.Traffic(generator.load("backlog"), cfg, 5)
    first = t.due(30_000)
    assert len(first) == sum(p["backlog"] for p in cfg["pools"])
    again = t.due(60_000, {"alpha": 3, "pool7": 2})
    assert sorted(a.pool for a in again) == ["alpha"] * 3 + ["pool7"] * 2


def test_sizes_are_exact_in_float32():
    """Every size a multiple of 512 MB and half a cpu, so float32 sums are
    exact in any order."""
    cfg = deploy.load_config("cook-8pool-10k")
    t = generator.Traffic(generator.load("backlog"), cfg, 9)
    jobs = t.due(30_000)
    mem = np.array([a.mem for a in jobs])
    cpus = np.array([a.cpus for a in jobs])
    assert (mem % 512 == 0).all() and (cpus * 2 % 1 == 0).all()
    hosts = deploy.make_hosts(cfg, 9)
    assert (hosts.mem % 512 == 0).all()
    per_pool = {}
    for pool, g in zip(hosts.pool, hosts.gpus):
        per_pool.setdefault(pool, []).append(g > 0)
    for pool in cfg["pools"]:
        assert sum(per_pool[pool["name"]]) == round(pool["hosts"] * 0.2)


def test_zipf_weights():
    w = generator.zipf_weights(50, 1.5)
    assert w.sum() == pytest.approx(1.0)
    assert w[0] / w[1] == pytest.approx(2 ** 1.5)


@pytest.mark.parametrize("config_name,traffic", CASES)
def test_other_seed_same_work(config_name, traffic):
    """Seeds differ in the order of the jobs, not in the work: a whole
    block holds the same users, sizes, priorities and runtimes."""
    cfg = deploy.rehearsal(deploy.load_config(config_name))
    cols = []
    for seed in (1, 2**31 + 7):
        t = generator.Traffic(generator.load(traffic), cfg, seed)
        st = t.streams[0]
        st.take(generator.BLOCK)
        cols.append({k: np.sort(v[:generator.BLOCK])
                     for k, v in st.cols.items()})
        assert len(set(np.asarray(st.user_names)[st.cols["user"]])) == len(
            st.user_names)
    for key in cols[0]:
        assert (cols[0][key] == cols[1][key]).all(), key


def test_fixed_column_counts():
    rng = np.random.default_rng(3)
    col = generator.fixed_column(rng, np.arange(3), 10, [0.5, 0.3, 0.2])
    assert np.bincount(col).tolist() == [5, 3, 2]
    rt = generator.exp_quantiles(rng, 120_000.0, 100_000)
    assert rt.mean() == pytest.approx(120_000.0, rel=1e-3)
