"""CapacityPlanner: the elastic capacity plane's control loop.

Port of `cook_tpu/elastic/planner.py`.  The plan solves on the
scheduler's device (`device=`, CUDA unless the caller asks for the CPU):
the padded inputs cross with `obs/data_plane.h2d` under the
`elastic-plan` family (or through a `ResidentRows` mirror with
`ElasticParams.resident`), `ops/elastic.py` solves, `fetch_result` ends
the timed solve.  The solve reports to the telemetry as the reference's
does (`record_solve("elastic_plan", (p_pad, j_pad), "xla", ...)`: the
backend label is the reference's, as the port's other solves keep
theirs).  The gauges, counter and histogram live in the port's
`utils/metrics` registry.

Cook's pools statically partition the fleet; this planner un-partitions
it on demand (the Aryl capacity-loaning design, arXiv:2202.07896):

  1. each planning interval it assembles per-pool DEMAND tensors (the
     DRU-ranked pending queues from scheduler/ranking.py, rank-weighted
     so the queue head dominates) and SUPPLY tensors (offered spare
     capacity per pool across every compute cluster);
  2. solves the loan/reclaim assignment as ONE bucket-padded batched
     tensor problem (`ops/elastic.py`; CPU parity in
     `ops/cpu_reference.py`), reporting the solve to the
     CompileObservatory like every other device solve;
  3. commits the resulting pool-capacity deltas through the txn
     pipeline as a durable `pool/capacity-delta` op — the LEDGER is the
     source of truth, durable before any cluster is touched — then
     converges every cluster's elastic capacity to the ledger-derived
     net per pool via the `ComputeCluster.scale` hook;
  4. records every decision in the ElasticRecorder ring
     and exports the loaned-capacity gauge and reclaim-latency
     histogram in the metrics registry.

Reclaim-on-demand (`reclaim_for`) is the reversibility half: the
rebalancer's victim search calls it BEFORE choosing preemption victims,
so a lender pool whose demand returns gets its loaned capacity back —
non-disruptively — before any task is killed for it.  Failover safety:
a promoted leader calls `reconcile()` and every cluster converges to
the replayed ledger, no matter where the old leader died between
commit and resize (scale() is declarative, hence idempotent).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from cook_tpu_torch.device import resolve
from cook_tpu_torch.elastic.recorder import ElasticRecorder, PlanRecord
from cook_tpu_torch.models.entities import Job, Resources
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.ops.common import bucket_size, fetch_result
from cook_tpu_torch.ops.elastic import (
    ELASTIC_RESOURCE_DIMS,
    ElasticProblem,
    solve_capacity_plan,
    weighted_demand,
)
from cook_tpu_torch.utils.metrics import global_registry

# a move dimension below its threshold is tensor dust, not capacity
MIN_MOVE = {"mem": 1.0, "cpus": 0.01, "gpus": 0.01}


@dataclass
class ElasticParams:
    """Knobs of the capacity plane (SchedulerConfig.elastic)."""

    enabled: bool = False
    # fraction of a lender's surplus kept home (never strip a pool bare)
    headroom: float = 0.1
    # queue position where rank-weighted demand discounts to half
    rank_half_life: int = 64
    # pending jobs counted toward reclaim-on-demand unmet demand
    reclaim_window: int = 100
    # ring capacity of /debug/elastic
    recorder_capacity: int = 256
    # block-shaped headroom: a waiting gang of k is unmet demand unless
    # some single topology block has k member-sized hosts free — scalar
    # spare can look sufficient while every block is fragmented, and a
    # loaned-out pool would never call its capacity home for the gang
    count_block_headroom: bool = True
    # topology block width for that check (0 = choose_nodes_per_block)
    gang_block_hosts: int = 0
    # serve the per-interval demand/capacity tensors from a
    # device-resident keyed-row mirror (device_state.ResidentRows):
    # pools whose queues did not change move zero encode bytes.
    # (the reference's config key [scheduler] resident_elastic; the port
    # sets it in Python until its config reader covers the section)
    resident: bool = False


class CapacityPlanner:
    """One leader's capacity plane (owned by the Scheduler)."""

    def __init__(self, store: JobStore, clusters: Sequence, txn,
                 params: Optional[ElasticParams] = None,
                 telemetry=None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.store = store
        self.device = resolve(device)
        # shared reference (the Scheduler's own list): dynamically added
        # compute clusters join the capacity plane automatically
        self.clusters = clusters
        self.txn = txn
        self.params = params or ElasticParams()
        self.telemetry = telemetry
        self.recorder = ElasticRecorder(
            capacity=self.params.recorder_capacity)
        self._loaned_gauge = global_registry.gauge(
            "elastic.loaned",
            "capacity currently on loan per (lender, borrower, resource)")
        self._plan_counter = global_registry.counter(
            "elastic.plans", "capacity-plan solves per kind")
        self._move_counter = global_registry.counter(
            "elastic.moves", "committed capacity moves per kind")
        self._reclaim_hist = global_registry.histogram(
            "elastic.reclaim.seconds",
            "reclaim-on-demand latency: unmet demand detected -> loaned "
            "capacity back in the lender pool's offers")
        self._unmet_gauge = global_registry.gauge(
            "elastic.unmet_shortage",
            "post-plan unmet shortage per pool/resource")
        self._gauge_keys: set[tuple] = set()
        self._resident = None
        if self.params.resident:
            from cook_tpu_torch.scheduler.device_state import ResidentRows

            self._resident = ResidentRows(
                "elastic",
                observatory=getattr(telemetry, "observatory", None),
                family=data_plane.FAM_ELASTIC, device=self.device)

    # ------------------------------------------------------- tensor builds

    def _active_pools(self) -> list[str]:
        return sorted(p.name for p in self.store.pools.values()
                      if p.schedules_jobs)

    def _supply(self, pools: list[str], p_pad: int) -> np.ndarray:
        from cook_tpu_torch.cluster.base import scan_pool_offers

        supply = np.zeros((p_pad, 3), dtype=np.float32)
        for i, pool in enumerate(pools):
            for _cluster, offer in scan_pool_offers(self.clusters, pool):
                supply[i, 0] += max(offer.mem, 0.0)
                supply[i, 1] += max(offer.cpus, 0.0)
                supply[i, 2] += max(offer.gpus, 0.0)
        return supply

    def _demand_inputs(self, pools: list[str], queues: dict,
                       p_pad: int) -> tuple[np.ndarray, np.ndarray, int]:
        longest = 1
        for pool in pools:
            queue = queues.get(pool)
            if queue is not None:
                longest = max(longest, len(queue.jobs))
        j_pad = bucket_size(longest)
        res = np.zeros((p_pad, j_pad, 3), dtype=np.float32)
        valid = np.zeros((p_pad, j_pad), dtype=bool)
        for i, pool in enumerate(pools):
            queue = queues.get(pool)
            if queue is None:
                continue
            for k, job in enumerate(queue.jobs[:j_pad]):
                r = job.resources
                res[i, k] = (r.mem, r.cpus, r.gpus)
                valid[i, k] = True
        return res, valid, j_pad

    def _outstanding(self, pools: list[str], p_pad: int) -> np.ndarray:
        idx = {pool: i for i, pool in enumerate(pools)}
        out = np.zeros((p_pad, p_pad, 3), dtype=np.float32)
        for row in self.store.encoded_capacity_ledger():
            li, bi = idx.get(row["from"]), idx.get(row["to"])
            if li is None or bi is None:
                continue
            out[li, bi] = (row["mem"], row["cpus"], row["gpus"])
        return out

    # ------------------------------------------------------- interval plan

    def plan_cycle(self, queues: dict) -> Optional[PlanRecord]:
        """One planning interval: solve, commit deltas, converge
        clusters, record.  Returns the PlanRecord (None with < 2 active
        pools — there is no one to loan to)."""
        pools = self._active_pools()
        if len(pools) < 2:
            return None
        p_pad = bucket_size(len(pools), minimum=8)
        res, valid, j_pad = self._demand_inputs(pools, queues, p_pad)
        supply = self._supply(pools, p_pad)
        outstanding = self._outstanding(pools, p_pad)
        pool_valid = np.arange(p_pad) < len(pools)

        t0 = time.perf_counter()
        if self._resident is not None:
            # keyed-row mirror: one [j_pad, 3] demand row per pool,
            # keyed by pool NAME — a pool whose pending queue did not
            # change since the last interval ships zero encode bytes.
            # j_pad growth flips the row width -> width-changed rebuild.
            cols, _stats = self._resident.build(
                pools,
                {"res": res[:len(pools)], "valid": valid[:len(pools)]},
                out_len=p_pad,
            )
            res_dev, valid_dev = cols["res"], cols["valid"]
            supply_dev = self._resident.whole_array("supply", supply)
            outstanding_dev = self._resident.whole_array(
                "outstanding", outstanding)
            pool_valid_dev = self._resident.whole_array(
                "pool_valid", pool_valid)
        else:
            with data_plane.family(data_plane.FAM_ELASTIC):
                res_dev, valid_dev, supply_dev, outstanding_dev, \
                    pool_valid_dev = (
                        data_plane.h2d(a, device=self.device)
                        for a in (res, valid, supply, outstanding,
                                  pool_valid))
        demand_dev = weighted_demand(
            res_dev, valid_dev, float(self.params.rank_half_life))
        plan = solve_capacity_plan(
            ElasticProblem(
                demand=demand_dev,
                supply=supply_dev,
                outstanding=outstanding_dev,
                pool_valid=pool_valid_dev,
            ),
            float(self.params.headroom),
        )
        demand, reclaim, loan, unmet = fetch_result(
            (demand_dev, plan.reclaim, plan.loan, plan.shortage))
        seconds = time.perf_counter() - t0

        compiled = False
        if self.telemetry is not None:
            compiled = self.telemetry.record_solve(
                "elastic_plan", (p_pad, j_pad), "xla", seconds)

        moves = (self._extract_moves(pools, reclaim, kind="reclaim")
                 + self._extract_moves(pools, loan, kind="loan"))
        txn_id = self._commit(moves)
        record = PlanRecord(
            plan_id=self.recorder.next_id(),
            kind="interval",
            t_ms=self.store.clock(),
            wall_time=time.time(),
            pools=pools,
            demand=self._per_pool(pools, demand),
            supply=self._per_pool(pools, supply),
            moves=moves,
            unmet=self._per_pool(pools, unmet, skip_zero=True),
            solve_shape=f"{p_pad}x{j_pad}",
            backend="xla",
            compiled=compiled,
            duration_s=seconds,
            txn_id=txn_id,
        )
        self.recorder.add(record)
        self._plan_counter.inc(labels={"kind": "interval"})
        for i, pool in enumerate(pools):
            for d, dim in enumerate(ELASTIC_RESOURCE_DIMS):
                self._unmet_gauge.set(float(unmet[i, d]),
                                      {"pool": pool, "resource": dim})
        return record

    def _extract_moves(self, pools: list[str], matrix: np.ndarray,
                       *, kind: str) -> list[dict]:
        moves = []
        for li, lender in enumerate(pools):
            for bi, borrower in enumerate(pools):
                if li == bi:
                    continue
                amounts = {
                    dim: float(matrix[li, bi, d])
                    for d, dim in enumerate(ELASTIC_RESOURCE_DIMS)
                }
                amounts = {dim: (v if v >= MIN_MOVE[dim] else 0.0)
                           for dim, v in amounts.items()}
                if any(v > 0 for v in amounts.values()):
                    moves.append({"kind": kind, "from": lender,
                                  "to": borrower, **amounts})
        return moves

    @staticmethod
    def _per_pool(pools: list[str], tensor: np.ndarray,
                  *, skip_zero: bool = False) -> dict:
        out = {}
        for i, pool in enumerate(pools):
            row = {dim: float(tensor[i, d])
                   for d, dim in enumerate(ELASTIC_RESOURCE_DIMS)}
            if skip_zero and not any(v > 1e-9 for v in row.values()):
                continue
            out[pool] = row
        return out

    # -------------------------------------------------- commit + converge

    def _commit(self, moves: list[dict]) -> str:
        """Ledger first (durable), clusters second (convergent)."""
        txn_id = ""
        if moves:
            outcome = self.txn.commit("pool/capacity-delta",
                                      {"moves": moves})
            txn_id = outcome.txn_id
            for move in moves:
                self._move_counter.inc(labels={"kind": move["kind"]})
        self.reconcile()
        return txn_id

    def reconcile(self) -> None:
        """Converge every cluster's elastic capacity to the ledger:
        called after each commit AND at promotion (components.py) — a
        leader that died between commit and resize leaves a ledger the
        next leader replays into the same scale() targets."""
        for pool in list(self.store.pools):
            net = self.store.net_capacity_adjustment(pool)
            cluster = self._scale_target(pool)
            if cluster is not None:
                cluster.scale(pool, net)
        self._export_ledger_gauges()

    def _scale_target(self, pool: str):
        """The cluster whose node-pool backs this pool (single-scalable-
        cluster deployments; with several, the one already offering in
        the pool wins)."""
        from cook_tpu_torch.cluster.base import safe_pool_offers

        scalable = [c for c in self.clusters if c.supports_scale()]
        for cluster in scalable:
            # guarded scan: reconcile_clusters runs after every commit,
            # so a flapping offers RPC must skip the cluster, not crash
            # the commit path (safe_pool_offers returns None on error)
            if safe_pool_offers(cluster, pool):
                return cluster
        return scalable[0] if scalable else None

    def _export_ledger_gauges(self) -> None:
        live: set[tuple] = set()
        for row in self.store.encoded_capacity_ledger():
            for dim in ELASTIC_RESOURCE_DIMS:
                key = (row["from"], row["to"], dim)
                live.add(key)
                self._loaned_gauge.set(
                    row[dim], {"from": key[0], "to": key[1],
                               "resource": dim})
        for key in self._gauge_keys - live:
            self._loaned_gauge.set(
                0.0, {"from": key[0], "to": key[1], "resource": key[2]})
        self._gauge_keys = live

    # --------------------------------------------------- reclaim-on-demand

    def reclaim_for(self, pool: str, pending: Sequence[Job],
                    host_spare: dict) -> Optional[dict]:
        """The rebalancer's pre-preemption hook: if `pool` has capacity
        on loan and its head-of-queue demand exceeds current spare,
        reclaim the shortfall (clamped at what is outstanding), commit
        it durably, converge clusters, and return the pool's REFRESHED
        host-spare map so the victim search runs against the returned
        capacity — preempting nobody the reclaim already satisfied.
        Returns None when nothing was reclaimed."""
        outstanding = self.store.outstanding_loans_from(pool)
        if not outstanding:
            return None
        need = {dim: 0.0 for dim in ELASTIC_RESOURCE_DIMS}
        for job in list(pending)[: self.params.reclaim_window]:
            need["mem"] += job.resources.mem
            need["cpus"] += job.resources.cpus
            need["gpus"] += job.resources.gpus
        for res in host_spare.values():
            need["mem"] -= res.mem
            need["cpus"] -= res.cpus
            need["gpus"] -= res.gpus
        unmet = {dim: max(v, 0.0) for dim, v in need.items()}
        starved = {dim for dim, v in unmet.items() if v >= MIN_MOVE[dim]}
        reclaim_kind = "reclaim-on-demand"
        if not starved and self.params.count_block_headroom:
            # scalar spare covers the queue, but does any single block
            # hold a waiting gang?  If not, the loan still starves us —
            # block-shaped headroom is the capacity that matters to gangs
            short = self._gang_block_shortfall(pending, host_spare)
            if short is not None:
                starved = {
                    dim for dim in short["dims"]
                    if any(outstanding[b].get(dim, 0.0) >= MIN_MOVE[dim]
                           for b in outstanding)}
                reclaim_kind = "reclaim-block-headroom"
        if not starved:
            return None
        t0 = time.perf_counter()
        # a starved dimension calls its WHOLE loan home (Aryl semantics:
        # lender demand returns, the loan returns).  Reclaiming only the
        # unmet amount under-delivers whenever the lender's spare map
        # already hides withheld-but-consumed capacity — the spare gain
        # from reclaiming X is min(X, physical free), so partial reclaim
        # can leave the victim search short and preempting anyway.
        moves = []
        for borrower in sorted(outstanding):
            amounts = {}
            for dim in ELASTIC_RESOURCE_DIMS:
                owed = outstanding[borrower][dim]
                amounts[dim] = (owed if dim in starved
                                and owed >= MIN_MOVE[dim] else 0.0)
            if any(v > 0 for v in amounts.values()):
                moves.append({"kind": "reclaim", "from": pool,
                              "to": borrower, **amounts})
        if not moves:
            return None
        txn_id = self._commit(moves)
        refreshed = self._pool_spare(pool)
        self._reclaim_hist.observe(time.perf_counter() - t0,
                                   {"pool": pool})
        self._plan_counter.inc(labels={"kind": reclaim_kind})
        self.recorder.add(PlanRecord(
            plan_id=self.recorder.next_id(),
            kind=reclaim_kind,
            t_ms=self.store.clock(),
            wall_time=time.time(),
            pools=[pool] + sorted(outstanding),
            moves=moves,
            duration_s=time.perf_counter() - t0,
            txn_id=txn_id,
        ))
        return refreshed

    def _gang_block_shortfall(self, pending: Sequence[Job],
                              host_spare: dict) -> Optional[dict]:
        """First waiting gang no topology block can hold: {group,
        gang_size, best_block, dims} or None.  Blocks are contiguous
        runs of the sorted host list, matching the planner's reading of
        the fleet (scheduler/gang.py)."""
        from cook_tpu_torch.ops.hierarchical import choose_nodes_per_block
        from cook_tpu_torch.scheduler.gang import waiting_gangs

        gangs = waiting_gangs(list(pending)[: self.params.reclaim_window])
        if not gangs or not host_spare:
            return None
        hostnames = sorted(host_spare)
        npb = (self.params.gang_block_hosts
               or choose_nodes_per_block(len(hostnames)))
        for group, jobs_g in gangs:
            k = max(j.gang_size for j in jobs_g)
            mem = max(j.resources.mem for j in jobs_g)
            cpus = max(j.resources.cpus for j in jobs_g)
            gpus = max(j.resources.gpus for j in jobs_g)
            best = 0
            for b in range(0, len(hostnames), npb):
                free = 0
                for h in hostnames[b:b + npb]:
                    r = host_spare[h]
                    if r.mem >= mem and r.cpus >= cpus and r.gpus >= gpus:
                        free += 1
                best = max(best, free)
            if best < k:
                dims = {d for d, v in (("mem", mem), ("cpus", cpus),
                                       ("gpus", gpus)) if v > 0}
                return {"group": group, "gang_size": k,
                        "best_block": best, "dims": dims}
        return None

    def _pool_spare(self, pool: str) -> dict:
        from cook_tpu_torch.cluster.base import scan_pool_offers

        spare: dict[str, Resources] = {}
        for _cluster, offer in scan_pool_offers(self.clusters, pool):
            spare[offer.hostname] = Resources(
                mem=offer.mem, cpus=offer.cpus, gpus=offer.gpus,
                disk=offer.disk)
        return spare
