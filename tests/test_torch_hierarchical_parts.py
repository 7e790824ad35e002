"""Pieces of `cook_tpu_torch.ops.hierarchical` and of its scheduler wiring
against `cook_tpu`'s on the CPU: a ragged job axis with invalid jobs, the
batched conflict round against `jax.vmap(conflict_round)`, block
aggregates, the host scatter, the fine gather with its dead-lane padding,
the geometry and config helpers, and the unknown backends, which
raise.  Inputs are exact-sum, as in tests/test_torch_hierarchical.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cook_tpu.ops import hierarchical as ref
from cook_tpu.ops.match import MatchProblem as RefProblem
from cook_tpu.ops.match import conflict_round as ref_conflict_round
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu_torch.ops import hierarchical as port
from cook_tpu_torch.ops.match import conflict_round_batched, from_numpy
from cook_tpu_torch.scheduler import matcher as port_matcher
from tests.test_torch_hierarchical import FAST, exact_problem, solve_both

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def test_invalid_jobs_and_a_ragged_job_axis():
    """A job axis that is not a power of two pads like the reference's,
    and invalid jobs are never placed."""
    demands, avail, totals, _ = exact_problem(100, 96, seed=3)
    job_valid = np.arange(100) % 7 != 0
    solve_both(demands, avail, totals, job_valid=job_valid,
               coarse_backend="pallas", fine_backend="pallas", **FAST)


@pytest.mark.parametrize("kc", [1, 4])
def test_batched_conflict_round_matches_vmap(kc):
    rng = np.random.default_rng(kc)
    b, s, n = 3, 24, 10
    d = np.stack([rng.choice([512, 1024, 2048], (b, s)),
                  rng.choice([1, 2, 4], (b, s)),
                  np.zeros((b, s))], -1).astype(np.float32)
    avail = np.stack([rng.integers(0, 9, (b, n)) * 512.0,
                      rng.integers(0, 17, (b, n)) * 0.5,
                      np.zeros((b, n))], -1).astype(np.float32)
    assignment = np.where(rng.uniform(size=(b, s)) < 0.2, 0, -1) \
        .astype(np.int32)
    cand_idx = rng.integers(0, n, (b, s, kc)).astype(np.int32)
    cand_val = np.where(rng.uniform(size=(b, s, kc)) < 0.9,
                        rng.uniform(size=(b, s, kc)), -1e30) \
        .astype(np.float32)
    recheck = rng.uniform(size=(b, s, n)) < 0.8

    def one(av, asg, cv, ci, dd, rm):
        return ref_conflict_round(av, asg, cv, ci, dd, n, recheck_mask=rm)

    args = (avail, assignment, cand_val, cand_idx, d, recheck)
    want_avail, want_asg = jax.vmap(one)(*map(jnp.asarray, args))
    got_avail, got_asg = conflict_round_batched(
        *map(torch.as_tensor, args[:5]), n,
        recheck_mask=torch.as_tensor(recheck))
    np.testing.assert_array_equal(got_asg.numpy(), np.asarray(want_asg))
    np.testing.assert_array_equal(got_avail.numpy(), np.asarray(want_avail))
    assert (got_asg.numpy() >= 0).sum() > (assignment >= 0).sum()


def test_block_aggregates_and_fine_gather_match_reference():
    demands, avail, totals, feasible = exact_problem(64, 96, seed=5,
                                                     masked=True)
    node_valid = np.arange(96) < 80
    want = ref.block_aggregates(jnp.asarray(avail), jnp.asarray(totals),
                                jnp.asarray(node_valid), 32)
    got = port.block_aggregates(torch.as_tensor(avail),
                                torch.as_tensor(totals),
                                torch.as_tensor(node_valid), 32)
    assert len(got) == len(want) == 5  # with the gang gate's host count
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    coarse = np.random.default_rng(5).integers(-1, 3, 64).astype(np.int32)
    job_idx, spilled = port.scatter_to_blocks(coarse, np.ones(64, bool),
                                              3, 16)
    want_idx, want_spilled = ref.scatter_to_blocks(coarse, np.ones(64, bool),
                                                   3, 16)
    np.testing.assert_array_equal(job_idx, want_idx)
    np.testing.assert_array_equal(spilled, want_spilled)
    jv = np.ones(64, bool)
    want_f = ref._pad_block_axis(ref.gather_fine(
        *map(jnp.asarray, (demands, jv, feasible, avail, totals,
                           node_valid, job_idx)), 32), 5, 4)
    got_f = port._pad_block_axis(port.gather_fine(
        *map(torch.as_tensor, (demands, jv, feasible, avail, totals,
                               node_valid, job_idx)), 32), 5, 4)
    for g, w in zip(got_f, want_f):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_layers_raise():
    for bad in (dict(coarse_backend="nope"), dict(fine_backend="nope"),
                dict(backend="nope")):
        with pytest.raises(ValueError):
            port.HierParams(**bad)
    for bad in (dict(hierarchical_coarse_backend="nope"),
                dict(hierarchical_fine_backend="nope")):
        with pytest.raises(ValueError):
            port_matcher.MatchConfig(**bad)


def test_choose_nodes_per_block_matches_reference():
    for n in (1, 60, 128, 300, 1000, 4096, 10_000, 16384, 131072):
        for override in (0, 48):
            assert (port.choose_nodes_per_block(n, override)
                    == ref.choose_nodes_per_block(n, override))


@pytest.mark.parametrize("backend", ["xla", "pallas", "bucketed"])
def test_hier_params_from_config_matches_reference(backend):
    knobs = dict(chunk=256, chunk_rounds=4, chunk_passes=3, chunk_kc=32,
                 backend=backend, hierarchical_threshold=1000,
                 hierarchical_nodes_per_block=64,
                 hierarchical_jobs_per_block=128,
                 hierarchical_refine_rounds=3,
                 hierarchical_coarse_backend="pallas",
                 hierarchical_fine_backend="pallas")
    got = port_matcher.hier_params_from_config(
        port_matcher.MatchConfig(**knobs))
    want = ref_matcher.hier_params_from_config(
        ref_matcher.MatchConfig(**knobs))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hierarchical_enabled_matches_reference():
    demands, avail, totals, _ = exact_problem(64, 32)
    problem = from_numpy(demands, np.ones(64, bool), avail, totals,
                         np.ones(32, bool), device="cpu")
    rproblem = RefProblem(*(None if a is None else jnp.asarray(a.numpy())
                            for a in problem))
    for threshold in (0, 1, 2048, 2049):
        got = port_matcher.hierarchical_enabled(
            port_matcher.MatchConfig(hierarchical_threshold=threshold),
            problem)
        want = ref_matcher.hierarchical_enabled(
            ref_matcher.MatchConfig(hierarchical_threshold=threshold),
            rproblem)
        assert got == want == (0 < threshold <= 2048)
