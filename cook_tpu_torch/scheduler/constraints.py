"""Constraint encoding: job/group placement rules -> tensor masks.

A copy of `cook_tpu/scheduler/constraints.py` (numpy throughout; the
mask crosses to the device in `scheduler/matcher.py`).

The reference evaluates a zoo of Fenzo constraint objects per (job, node)
pair (Cook's scheduler/constraints.clj).  Here
constraints are split the way SURVEY §7 prescribes:

  * vectorizable constraints (novel-host, gpu-host, attribute EQUALS,
    max-tasks-per-host, group member-exclusion) are encoded host-side into
    one [J, N] boolean feasibility mask fed to the match kernel — numpy
    vectorized, O(J*N) bitwork, no Python loops over pairs;

  * order-dependent group constraints (unique-host / balanced /
    attribute-equals *within the current cycle*) are enforced by a
    post-kernel validation pass that unassigns violators (they simply wait
    a cycle, like any unplaced job).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from cook_tpu_torch.cluster.base import Offer
from cook_tpu_torch.ops.common import binpack_fitness
from cook_tpu_torch.models.entities import (
    Group,
    GroupPlacementType,
    Job,
)

# Balanced-host treats a host with the attribute absent as carrying a nil
# VALUE that participates in the frequency map (the reference maps cohost
# attr maps with `get`, so nils are counted — constraints.clj:600), not as
# an infeasible host.
MISSING_ATTR = "\x00missing"


def _closed_value_mask(
    counts: dict[str, int],
    minimum: int,
    codes: np.ndarray,
    vocab: dict[str, int],
) -> np.ndarray:
    """[N] bool: nodes whose attribute value is closed to a balanced group
    under `counts` — value at the max member count while counts are skewed
    (until `minimum` distinct values are in play the floor is pinned to 0,
    forcing spread onto unseen values).  The single encoding of the rule
    shared by the pre-mask closure and the post-solve top-up."""
    closed = np.zeros(codes.shape[0], dtype=bool)
    if not counts:
        return closed
    minim = 0 if minimum > len(counts) else min(counts.values())
    maxim = max(counts.values())
    if minim == maxim:
        return closed
    for value, c in counts.items():
        if c < maxim:
            continue
        if value == MISSING_ATTR:
            closed |= codes == -1
        else:
            closed |= codes == vocab.get(value, -2)
    return closed


@dataclass
class EncodedNodes:
    """Host-side encoding of one pool's offers."""

    offers: list[Offer]
    hostname_to_idx: dict[str, int]
    has_gpus: np.ndarray          # [N] bool
    attr_codes: dict[str, np.ndarray]  # attr name -> [N] int codes (-1 missing)
    attr_vocab: dict[str, dict[str, int]]

    @property
    def n(self) -> int:
        return len(self.offers)


def encode_nodes(offers: Sequence[Offer]) -> EncodedNodes:
    hostname_to_idx = {o.hostname: i for i, o in enumerate(offers)}
    has_gpus = np.array([o.gpus > 0 for o in offers], dtype=bool)
    attr_names = set()
    for o in offers:
        attr_names.update(dict(o.attributes).keys())
    attr_codes: dict[str, np.ndarray] = {}
    attr_vocab: dict[str, dict[str, int]] = {}
    for name in attr_names:
        vocab: dict[str, int] = {}
        codes = np.full(len(offers), -1, dtype=np.int32)
        for i, o in enumerate(offers):
            val = dict(o.attributes).get(name)
            if val is None:
                continue
            if val not in vocab:
                vocab[val] = len(vocab)
            codes[i] = vocab[val]
        attr_codes[name] = codes
        attr_vocab[name] = vocab
    return EncodedNodes(
        offers=list(offers),
        hostname_to_idx=hostname_to_idx,
        has_gpus=has_gpus,
        attr_codes=attr_codes,
        attr_vocab=attr_vocab,
    )


def feasibility_mask(
    jobs: Sequence[Job],
    nodes: EncodedNodes,
    *,
    previous_hosts: Optional[dict[str, set[str]]] = None,
    group_used_hosts: Optional[dict[str, set[str]]] = None,
    group_attr_value: Optional[dict[str, tuple[str, str]]] = None,
    group_balance_counts: Optional[dict[str, dict[str, int]]] = None,
    groups: Optional[dict[str, Group]] = None,
    tasks_on_host: Optional[dict[str, int]] = None,
    max_tasks_per_host: int = 0,
    offer_locations: Optional[Sequence[str]] = None,
    job_est_end_ms: Optional[np.ndarray] = None,
    host_lifetime_mins: float = 0.0,
    balanced_pre_rows: Optional[dict[int, np.ndarray]] = None,
) -> np.ndarray:
    """Build the [J, N] mask.

    previous_hosts: job uuid -> hostnames of prior failed instances
      (novel-host constraint, constraints.clj:68).
    group_used_hosts: group uuid -> hostnames already used by RUNNING group
      members (unique-host member exclusion, constraints.clj:586).
    group_attr_value: group uuid -> (attr, value) pinned by running members
      (attribute-equals, constraints.clj:628).
    tasks_on_host + max_tasks_per_host: constraints.clj:433.
    """
    j, n = len(jobs), nodes.n
    mask = np.ones((j, n), dtype=bool)
    if n == 0:
        return mask

    # gpu-host constraint (constraints.clj:122): gpu jobs only on gpu nodes,
    # non-gpu jobs never on gpu nodes.
    job_gpu = np.array([job.resources.gpus > 0 for job in jobs], dtype=bool)
    mask &= job_gpu[:, None] == nodes.has_gpus[None, :]

    # disk type (disk-host-constraint, constraints.clj:164): a typed disk
    # request only matches hosts advertising that "disk-type" attribute
    # (space binpacking is the kernel's 4th resource column)
    job_disk_type = [job.resources.disk_type for job in jobs]
    if any(job_disk_type):
        host_disk_type = np.array(
            [dict(o.attributes).get("disk-type", "") for o in nodes.offers])
        for ji, want in enumerate(job_disk_type):
            if want:
                mask[ji, :] &= host_disk_type == want

    # port count: a job requesting N ports only fits offers carrying >= N
    # free ports (mesos/task.clj port resources); concrete assignment
    # happens post-solve in the matcher
    job_ports = np.array([job.resources.ports for job in jobs])
    if job_ports.any():
        avail_ports = np.array([o.port_count() for o in nodes.offers])
        mask &= job_ports[:, None] <= avail_ports[None, :]

    # estimated completion vs host lifetime (constraints.clj:385): skip
    # hosts expected to die before the job's estimated end; hosts without
    # a "host-start-time" attribute (epoch seconds) always pass
    if job_est_end_ms is not None and host_lifetime_mins > 0:
        start_s = np.array(
            [float(dict(o.attributes).get("host-start-time", -1))
             for o in nodes.offers])
        death_ms = start_s * 1000.0 + host_lifetime_mins * 60_000.0
        no_estimate = job_est_end_ms < 0
        mask &= (no_estimate[:, None] | (start_s < 0)[None, :]
                 | (job_est_end_ms[:, None] < death_ms[None, :]))

    # max tasks per host
    if max_tasks_per_host and tasks_on_host:
        full = np.array(
            [tasks_on_host.get(o.hostname, 0) >= max_tasks_per_host
             for o in nodes.offers],
            dtype=bool,
        )
        mask &= ~full[None, :]

    loc_arr = (np.array(offer_locations) if offer_locations is not None
               else None)
    for ji, job in enumerate(jobs):
        # checkpoint locality (constraints.clj:218): a job restarting from a
        # checkpoint only runs where its checkpoint is reachable
        if (job.checkpoint is not None and job.checkpoint.location
                and loc_arr is not None):
            mask[ji, :] &= loc_arr == job.checkpoint.location
        # novel-host: never revisit a host this job failed on
        if previous_hosts:
            for hostname in previous_hosts.get(job.uuid, ()):
                idx = nodes.hostname_to_idx.get(hostname)
                if idx is not None:
                    mask[ji, idx] = False
        # user-specified attribute constraints (EQUALS)
        for c in job.constraints:
            codes = nodes.attr_codes.get(c.attribute)
            if codes is None:
                mask[ji, :] = False
                continue
            want = nodes.attr_vocab[c.attribute].get(c.pattern, -2)
            mask[ji, :] &= codes == want
        # group placement derived from already-running members
        if job.group_uuid and groups:
            group = groups.get(job.group_uuid)
            if group is not None:
                ptype = group.host_placement.type
                if ptype == GroupPlacementType.UNIQUE and group_used_hosts:
                    for hostname in group_used_hosts.get(job.group_uuid, ()):
                        idx = nodes.hostname_to_idx.get(hostname)
                        if idx is not None:
                            mask[ji, idx] = False
                elif (ptype == GroupPlacementType.ATTRIBUTE_EQUALS
                      and group_attr_value):
                    pinned = group_attr_value.get(job.group_uuid)
                    if pinned is not None:
                        attr, value = pinned
                        codes = nodes.attr_codes.get(attr)
                        if codes is None:
                            mask[ji, :] = False
                        else:
                            want = nodes.attr_vocab[attr].get(value, -2)
                            mask[ji, :] &= codes == want
                elif (ptype == GroupPlacementType.BALANCED
                      and group_balance_counts):
                    # the running-member part of balanced-host
                    # (constraints.clj:600) is order-independent, so it is
                    # enforced up front: attribute values already at the
                    # max member count are closed to the group (otherwise
                    # the kernel would keep picking the fittest closed host
                    # and the post-pass would reject it every cycle)
                    counts = group_balance_counts.get(job.group_uuid)
                    if counts:
                        attr = group.host_placement.attribute
                        minimum = group.host_placement.minimum
                        codes = nodes.attr_codes.get(attr)
                        if codes is None:
                            # attr absent from every offer: all hosts carry
                            # the nil value (code -1), same as the post-pass
                            codes = np.full(nodes.n, -1, dtype=np.int32)
                        closed = _closed_value_mask(
                            counts, minimum, codes,
                            nodes.attr_vocab.get(attr, {}))
                        if closed.any():
                            # intra-cycle leveling can re-open a closed
                            # value; keep the pre-closure row so the
                            # post-solve top-up (balanced_group_topup) can
                            # retry against live counts
                            if balanced_pre_rows is not None:
                                balanced_pre_rows[ji] = mask[ji].copy()
                            mask[ji, :] &= ~closed
    return mask


def validate_group_assignments(
    jobs: Sequence[Job],
    assignment: np.ndarray,
    nodes: EncodedNodes,
    groups: dict[str, Group],
    group_used_hosts: dict[str, set[str]],
    group_attr_value: dict[str, tuple[str, str]],
    group_balance_counts: Optional[dict[str, dict[str, int]]] = None,
    out_balance_counts: Optional[dict[str, dict[str, int]]] = None,
) -> np.ndarray:
    """Post-kernel pass enforcing intra-cycle group semantics: walk matches
    in schedule order; a match that violates its group's unique-host /
    attribute-equals placement against *earlier* matches this cycle is
    unassigned (set to -1).  Returns the corrected assignment.

    `group_balance_counts` seeds the balanced-host skew counts with RUNNING
    members — including those on hosts outside this cycle's offer set — so
    the constraint matches the reference's all-running-members semantics
    (constraints.clj:600), not just intra-cycle placements."""
    assignment = assignment.copy()
    used: dict[str, set[str]] = {g: set(h) for g, h in group_used_hosts.items()}
    pinned: dict[str, tuple[str, str]] = dict(group_attr_value)
    # balanced: per-group count of members per attribute value, seeded with
    # running members
    balance_counts: dict[str, dict[str, int]] = {
        g: dict(c) for g, c in (group_balance_counts or {}).items()
    }
    for ji, job in enumerate(jobs):
        node_idx = int(assignment[ji])
        if node_idx < 0 or not job.group_uuid:
            continue
        group = groups.get(job.group_uuid)
        if group is None:
            continue
        hostname = nodes.offers[node_idx].hostname
        ptype = group.host_placement.type
        if ptype == GroupPlacementType.UNIQUE:
            seen = used.setdefault(job.group_uuid, set())
            if hostname in seen:
                assignment[ji] = -1
                continue
            seen.add(hostname)
        elif ptype == GroupPlacementType.ATTRIBUTE_EQUALS:
            attr = group.host_placement.attribute
            value = dict(nodes.offers[node_idx].attributes).get(attr)
            if value is None:
                assignment[ji] = -1
                continue
            prev = pinned.get(job.group_uuid)
            if prev is None:
                pinned[job.group_uuid] = (attr, value)
            elif prev != (attr, value):
                assignment[ji] = -1
        elif ptype == GroupPlacementType.BALANCED:
            # balanced-host (constraints.clj:600): a member may land on an
            # already-seen attribute value only if that value's member count
            # is below the current max (or all seen values are level); until
            # `minimum` distinct values are in play the floor is pinned to 0,
            # which forces spreading onto unseen values.  Unseen values
            # always pass.
            attr = group.host_placement.attribute
            minimum = group.host_placement.minimum
            value = dict(nodes.offers[node_idx].attributes).get(
                attr, MISSING_ATTR)
            counts = balance_counts.setdefault(job.group_uuid, {})
            freq = counts.get(value)
            if counts and freq is not None:
                minim = 0 if minimum > len(counts) else min(counts.values())
                maxim = max(counts.values())
                if minim != maxim and freq >= maxim:
                    assignment[ji] = -1
                    continue
            counts[value] = counts.get(value, 0) + 1
    if out_balance_counts is not None:
        out_balance_counts.update(balance_counts)
    return assignment


def balanced_group_topup(
    jobs: Sequence[Job],
    assignment: np.ndarray,
    nodes: EncodedNodes,
    groups: dict[str, Group],
    balance_counts: dict[str, dict[str, int]],
    balanced_pre_rows: dict[int, np.ndarray],
    remaining_avail: np.ndarray,
    demands: np.ndarray,
    totals: np.ndarray,
) -> np.ndarray:
    """Second chance for balanced-group jobs the pre-mask closed out.

    The pre-mask closes attribute values already at the max member count
    using counts seeded BEFORE the solve; placements made during the cycle
    can level those counts and legitimately re-open a closed value — which
    the kernel, solving against the stale mask, could never propose.  This
    host-side pass walks still-unplaced jobs whose rows the closure
    restricted (in schedule order), re-evaluating admissibility against the
    LIVE post-cycle counts (the same rule as validate_group_assignments)
    and placing on the best-fitting node with enough remaining resources.

    `remaining_avail`/`demands` are [N, R]/[J, R] in the kernel's resource
    layout; both are mutated-by-copy (the returned assignment reflects the
    extra placements, `remaining_avail` is updated in place so callers see
    consumed capacity).
    """
    for ji in sorted(balanced_pre_rows):
        if assignment[ji] >= 0:
            continue
        job = jobs[ji]
        group = groups.get(job.group_uuid) if job.group_uuid else None
        if group is None or (group.host_placement.type
                             != GroupPlacementType.BALANCED):
            continue
        attr = group.host_placement.attribute
        minimum = group.host_placement.minimum
        counts = balance_counts.setdefault(job.group_uuid, {})
        codes = nodes.attr_codes.get(attr)
        if codes is None:
            codes = np.full(nodes.n, -1, dtype=np.int32)
        vocab = nodes.attr_vocab.get(attr, {})
        # admissible values under LIVE counts (same rule as the pre-mask
        # closure and the post-pass, via the shared helper)
        closed = _closed_value_mask(counts, minimum, codes, vocab)
        ok = (balanced_pre_rows[ji]
              & ~closed
              & np.all(remaining_avail >= demands[ji][None, :], axis=-1))
        if not ok.any():
            continue
        # best-fit: the kernel's own fitness (shared definition), so the
        # top-up doesn't undo the solve's packing quality
        denom = np.maximum(totals, 1e-30)
        used = totals - remaining_avail[:, :2]
        fit_val = binpack_fitness(used[:, 0], used[:, 1], demands[ji][0],
                                  demands[ji][1], denom[:, 0], denom[:, 1])
        fit = np.where(ok, fit_val, -np.inf)
        node_idx = int(np.argmax(fit))
        assignment[ji] = node_idx
        remaining_avail[node_idx] -= demands[ji]
        value = dict(nodes.offers[node_idx].attributes).get(
            attr, MISSING_ATTR)
        counts[value] = counts.get(value, 0) + 1
    return assignment
