"""Config file handling: JSON -> validated settings dataclasses.

Port of `cook_tpu/utils/config.py` (reference: cook.config, config.clj —
EDN + prismatic-schema validation, docs/configuration.adoc) including the
pool-regex-scoped scheduler configs (`pool-schedulers`, regexp_tools.clj)
and runtime-mutable sections: `Settings`, `read_config`, the match,
rebalancer and elastic sections, the `resident_rebalancer` /
`resident_elastic` shorthands, and `default_match_config` with the
tuned-defaults file.  The match section's `device_fallback_cycles` and
`device_latency_guard` (the reference's CPU fallback ladder, which the
port deliberately does not have) are read and dropped.

`Settings.platform` names the port's device: "" is the card
(`device.resolve(None)`, which raises without one) and "cpu" the CPU;
anything else is refused by `read_config` (`device_for_platform`).
"""
from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from cook_tpu_torch.scheduler.matcher import MatchConfig
from cook_tpu_torch.scheduler.rebalancer import RebalancerParams

log = logging.getLogger(__name__)


def tuned_match_defaults(path: Optional[str] = None) -> dict:
    """Hardware-sweep-promoted matcher defaults.

    `tools/pick_tuned.py` writes the best measured sweep config (packing
    efficiency >= its --min-eff bar vs the sequential-greedy oracle) to
    `tuned_match.json`; the service treats it as the DEFAULT matcher
    config so production gets the tuned chunked kernel, not the exact
    O(J)-scan fallback.  Explicit `match` config keys always win.
    Exactly ONE source is consulted: the `path` arg when given;
    otherwise $COOK_TUNED_MATCH when set (""/"none"/"off" disables tuned
    defaults entirely); otherwise the repo-root tuned_match.json.
    Returns {} (pure dataclass defaults) when the consulted source is
    absent or unreadable.
    """
    env = os.environ.get("COOK_TUNED_MATCH")
    if path:
        candidates = [path]
    elif env is not None:
        candidates = [] if env.lower() in ("", "none", "off") else [env]
    else:
        candidates = [os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "tuned_match.json")]
    for p in candidates:
        try:
            with open(p) as f:
                loaded = json.load(f)
        except FileNotFoundError:
            continue
        except (OSError, ValueError) as e:
            # an EXISTING tuned file that cannot be read/parsed silently
            # reverting production to the untuned exact kernel is the
            # perf trap this mechanism exists to prevent — say so
            log.warning("tuned match config %s exists but is unusable "
                        "(%s); falling back to untuned defaults", p, e)
            continue
        if not isinstance(loaded, dict):
            log.warning("tuned match config %s is not a JSON object; "
                        "falling back to untuned defaults", p)
            continue
        # pick_tuned writes sweep-style names (rounds/passes/kc);
        # translate to the MatchConfig field names
        out = {}
        for src, dst in (("chunk", "chunk"), ("rounds", "chunk_rounds"),
                         ("passes", "chunk_passes"), ("kc", "chunk_kc"),
                         ("backend", "backend")):
            if src in loaded:
                out[dst] = loaded[src]
        return out
    return {}


@dataclass
class PoolSchedulerConfig:
    """Per-pool-regex matcher knobs (reference `pool-schedulers`)."""

    pool_regex: str
    match: MatchConfig = field(default_factory=MatchConfig)

    def matches(self, pool_name: str) -> bool:
        return re.fullmatch(self.pool_regex, pool_name) is not None


@dataclass
class Settings:
    port: int = 12321
    default_pool: str = "default"
    mea_culpa_failure_limit: int = 5
    rank_interval_s: float = 5.0
    match_interval_s: float = 1.0
    rebalancer_interval_s: float = 20.0
    lingering_interval_s: float = 60.0
    straggler_interval_s: float = 60.0
    cancelled_interval_s: float = 3.0
    optimizer_interval_s: float = 0.0   # 0 = disabled
    rebalancer: RebalancerParams = field(default_factory=RebalancerParams)
    match: MatchConfig = field(default_factory=MatchConfig)
    pool_schedulers: list[PoolSchedulerConfig] = field(default_factory=list)
    pools: list[dict] = field(default_factory=lambda: [{"name": "default"}])
    clusters: list[dict] = field(default_factory=list)
    # one batched device call for all pools per match tick instead of
    # round-robin one-pool-per-tick (docs/tpu-design.md pool sharding)
    batched_match: bool = False
    # pipelined multi-pool match pass (scheduler/pipeline.py): overlap
    # host encode/launch with the device solve; takes precedence over
    # batched_match when both are set
    pipelined_match: bool = False
    # prediction-assisted speculative cycles (scheduler/prediction.py):
    # pre-dispatch cycle N+1's solve against the predicted offer set
    # while cycle N's launches drain; a stale speculation is dropped at
    # commit, never repaired.  Off by default.
    speculation: bool = False
    # how far ahead (wall ms) a running task's predicted finish may sit
    # and still be assumed complete by the speculative solve
    speculation_horizon_ms: float = 30_000.0
    # runtime-predictor knobs (per-(user, command-fingerprint) rolling
    # quantiles; scheduler/prediction.QuantileRuntimePredictor)
    predictor_quantile: float = 0.75
    predictor_window: int = 64
    predictor_min_samples: int = 3
    # predicted-duration backfill: bounded DRU scoring term (ops/dru.py);
    # 0 disables (rank order untouched)
    backfill_weight: float = 0.0
    backfill_norm_ms: float = 600_000.0
    leader_lease_path: str = ""
    # networked election (control/lease_server.py — the ZK role): takes
    # precedence over leader_lease_path when set
    leader_endpoint: str = ""
    leader_group: str = "cook"
    leader_ttl_s: float = 10.0
    # URL peers reach THIS node at (lease advertisement + standby
    # replication); default http://127.0.0.1:{port}
    advertised_url: str = ""
    # identity standbys present to the leader's /replication endpoints
    # (must be in the leader's admins)
    replication_user: str = "admin"
    # durable-on-ack submissions (datomic.clj:79 semantics): POST /jobs
    # blocks until >= replication_min_acks standbys confirmed the write,
    # bounded by replication_ack_timeout_s (a timeout still commits but
    # the response carries "replicated": false)
    replication_sync_ack: bool = False
    replication_min_acks: int = 1
    replication_ack_timeout_s: float = 5.0
    # acks older than this stop counting toward min_acks (decommissioned
    # standbys are pruned); <= 0 disables liveness qualification
    replication_ack_liveness_s: float = 30.0
    data_dir: str = ""                  # "" = in-memory only
    snapshot_interval_s: float = 300.0
    # sharded control plane (cook_tpu/shard/): partition the store,
    # journal, idempotency table, and replication stream into this many
    # shards (per-pool routing, hashed-user fallback).  1 = the classic
    # single-store layout, byte-for-byte unchanged.  A data_dir laid out
    # for the single journal auto-migrates (exactly once, manifest-
    # stamped) at startup when shards > 1.
    shards: int = 1
    # replica-served reads (cook_tpu/shard/replica.py): non-leader nodes
    # serve heavy read endpoints from their replayed journal with
    # bounded staleness (X-Cook-Staleness-Ms); above the ceiling the
    # read falls back to the leader, and a replica that stopped applying
    # for replica_refuse_after_s refuses reads
    replica_reads: bool = True
    replica_staleness_ceiling_ms: float = 5000.0
    replica_refuse_after_s: float = 30.0
    # the scheduler's device: "" = the card (CUDA; the process refuses to
    # start without one), "cpu" = the CPU (tests, control-plane-only
    # nodes); see device_for_platform
    platform: str = ""
    admins: tuple = ("admin",)
    queue_limit_per_pool: int = 1_000_000
    queue_limit_per_user: int = 100_000
    submission_rate_per_minute: float = 0.0
    cors_origins: tuple = ()  # exact strings or regexes; empty = no CORS
    # authenticator config ({"kind": "dev"|"basic"|"spnego"|"composite"});
    # empty = the permissive dev stack (rest/auth.py)
    auth: dict = field(default_factory=dict)
    # shared secret for executor heartbeat/progress posts ("" = not
    # enforced); executors read it from COOK_EXECUTOR_TOKEN
    executor_token: str = ""
    # plugin seams: dotted paths per seam + pool-mover rules
    # (scheduler/plugins.py registry_from_config)
    plugins: dict = field(default_factory=dict)
    # elastic capacity plane (cook_tpu/elastic/): planning-interval
    # trigger (0 = disabled) + planner knobs ({"headroom": ...,
    # "rank_half_life": ..., "reclaim_window": ...})
    elastic_interval_s: float = 0.0
    elastic: dict = field(default_factory=dict)
    # REST-layer knobs beyond the dedicated top-level keys
    # ({"max_gang_size": ...}; docs/configuration.md "Gang scheduling")
    api: dict = field(default_factory=dict)
    # resilience plane (docs/resilience.md):
    # POST /debug/faults arm/disarm — NEVER enable outside a chaos drill
    fault_injection: bool = False
    # what a journal fsync FAILURE means: "fail-stop" (commit reports
    # undurable + leader demotes) or "degrade-async" (keep committing
    # without the disk barrier, health reason journal-fsync-degraded)
    journal_fsync_policy: str = "fail-stop"
    # 429 + Retry-After on heavy reads while the commit-ack SLO burns
    load_shedding: bool = True
    # incident observatory (cook_tpu/obs/incident.py): ok->degraded
    # health transitions snapshot evidence bundles (GET /debug/incidents).
    # incident_dir "" = data_dir/incidents when data_dir is set, else
    # in-memory only; the health-watch loop evaluates the merged verdict
    # every interval so capture doesn't depend on external probes
    incident_dir: str = ""
    incident_capacity: int = 32
    incident_cooldown_s: float = 30.0
    health_watch_interval_s: float = 15.0
    # durable multi-resolution metrics history (cook_tpu/obs/tsdb.py):
    # a background sampler polls the metrics registry every
    # history_sample_s into raw -> 1m -> 10m rollup rings, persisted
    # under data_dir/metrics/ and served at GET /debug/history.
    # <= 0 disables the sampler (the endpoint still serves, empty).
    history_sample_s: float = 10.0
    # retention overrides ({"raw_points": .., "rollup_points": ..,
    # "segment_lines": .., "max_segments": .., "key_series": [..],
    # "incident_window_s": ..}); {} = HistoryConfig defaults
    history_retention: dict = field(default_factory=dict)
    # fleet observatory (cook_tpu/obs/fleet.py), a leader duty: poll
    # every known peer (this list + every standby registered through
    # replication acks) for health/staleness every fleet_poll_s and
    # serve the merged verdict at GET /debug/fleet.  <= 0 disables.
    peers: tuple = ()
    fleet_poll_s: float = 5.0
    # automatic device-profile capture on device-latency-shaped
    # degradations (solve-latency-regression, device-degraded),
    # cooldown-rate-limited; POST /debug/profile works regardless.
    # commit-ack-slo-burn deliberately never auto-profiles: the
    # capture's overhead deepens a control-plane burn (obs/profiling.py)
    auto_profile: bool = True
    profile_dir: str = ""

    def match_config_for_pool(self, pool_name: str) -> MatchConfig:
        for ps in self.pool_schedulers:
            if ps.matches(pool_name):
                return ps.match
        return self.match


def _match_config(d: dict) -> MatchConfig:
    tuned = tuned_match_defaults()
    d = {**tuned, **d}  # explicit config keys override tuned defaults
    return MatchConfig(
        max_jobs_considered=int(d.get("max_jobs_considered", 1000)),
        scaleback=float(d.get("scaleback", 0.95)),
        chunk=int(d.get("chunk", 0)),
        chunk_rounds=int(d.get("chunk_rounds", 6)),
        chunk_passes=int(d.get("chunk_passes", 2)),
        chunk_kc=int(d.get("chunk_kc", 128)),
        backend=str(d.get("backend", "xla")),
        quality_audit_every=int(d.get("quality_audit_every", 50)),
        completion_multiplier=float(d.get("completion_multiplier", 0.0)),
        host_lifetime_mins=float(d.get("host_lifetime_mins", 0.0)),
        agent_start_grace_mins=float(d.get("agent_start_grace_mins", 10.0)),
        checkpoint_memory_overhead_mb=float(
            d.get("checkpoint_memory_overhead_mb", 0.0)),
        # hierarchical two-level matcher (ops/hierarchical.py): engages
        # when padded jobs x nodes reaches the threshold (0 = off)
        hierarchical_threshold=int(d.get("hierarchical_threshold", 0)),
        hierarchical_nodes_per_block=int(
            d.get("hierarchical_nodes_per_block", 0)),
        hierarchical_jobs_per_block=int(
            d.get("hierarchical_jobs_per_block", 0)),
        hierarchical_refine_rounds=int(
            d.get("hierarchical_refine_rounds", 2)),
        # superblock (DCN-domain) layer above the topology blocks:
        # nodes per superblock, 0 = single-level coarse pass.  Primary
        # key `hier_superblock_nodes`; the long form is an alias.
        hierarchical_superblock_nodes=int(
            d.get("hier_superblock_nodes",
                  d.get("hierarchical_superblock_nodes", 0))),
        hierarchical_coarse_backend=str(
            d.get("hierarchical_coarse_backend", "xla")),
        hierarchical_use_mesh=bool(d.get("hierarchical_use_mesh", True)),
        hierarchical_fine_backend=str(
            d.get("hierarchical_fine_backend", "xla")),
        # device-resident match state + quantized cost tensors
        # (scheduler/device_state.py; docs/configuration.md)
        device_residency=bool(d.get("device_residency", False)),
        quantized=bool(d.get("quantized", False)),
        quantization_parity_floor=float(
            d.get("quantization_parity_floor",
                  MatchConfig.quantization_parity_floor)),
        # topology-aware gang scheduling (scheduler/gang.py;
        # docs/configuration.md "Gang scheduling")
        gang_enabled=bool(d.get("gang_enabled", True)),
        topology_weight=float(d.get("topology_weight", 0.0)),
        topology_block_hosts=int(d.get("topology_block_hosts", 0)),
    )


def default_match_config(**overrides) -> MatchConfig:
    """The service/sim default matcher config: dataclass defaults merged
    under the hardware-tuned `tuned_match.json` (when present) and any
    explicit overrides (highest precedence)."""
    return _match_config(overrides)


def device_for_platform(platform: str) -> Optional[str]:
    """The device argument `Settings.platform` stands for: None (the
    card, through `device.resolve`) for "", "cpu" for "cpu"."""
    if platform == "":
        return None
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"bad platform {platform!r} (\"\" = the CUDA card, "
                     "\"cpu\")")


def read_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Settings:
    data: dict[str, Any] = {}
    if path:
        with open(path) as f:
            data = json.load(f)
    if overrides:
        data.update(overrides)
    settings = Settings()
    for key in ("port", "default_pool", "mea_culpa_failure_limit",
                "rank_interval_s", "match_interval_s",
                "rebalancer_interval_s", "optimizer_interval_s",
                "leader_lease_path", "leader_endpoint", "leader_group",
                "leader_ttl_s", "advertised_url", "replication_user",
                "replication_sync_ack", "replication_min_acks",
                "replication_ack_timeout_s", "replication_ack_liveness_s",
                "data_dir", "snapshot_interval_s", "platform",
                "shards", "replica_reads",
                "replica_staleness_ceiling_ms", "replica_refuse_after_s",
                "batched_match", "pipelined_match", "speculation",
                "speculation_horizon_ms", "predictor_quantile",
                "predictor_window", "predictor_min_samples",
                "backfill_weight", "backfill_norm_ms",
                "elastic_interval_s",
                "fault_injection", "journal_fsync_policy", "load_shedding",
                "incident_dir", "incident_capacity", "incident_cooldown_s",
                "health_watch_interval_s", "auto_profile", "profile_dir",
                "history_sample_s", "fleet_poll_s",
                "queue_limit_per_pool",
                "queue_limit_per_user", "submission_rate_per_minute"):
        if key in data:
            setattr(settings, key, data[key])
    if "admins" in data:
        settings.admins = tuple(data["admins"])
    if "cors_origins" in data:
        settings.cors_origins = tuple(data["cors_origins"])
    if "auth" in data:
        settings.auth = dict(data["auth"])
    if "plugins" in data:
        settings.plugins = dict(data["plugins"])
    if "elastic" in data:
        settings.elastic = dict(data["elastic"])
    if "api" in data:
        settings.api = dict(data["api"])
    if "executor_token" in data:
        settings.executor_token = str(data["executor_token"])
    if "peers" in data:
        settings.peers = tuple(data["peers"])
    if "history_retention" in data:
        settings.history_retention = dict(data["history_retention"])
    if "pools" in data:
        settings.pools = data["pools"]
    if "clusters" in data:
        settings.clusters = data["clusters"]
    if "rebalancer" in data:
        rb = data["rebalancer"]
        settings.rebalancer = RebalancerParams(
            safe_dru_threshold=float(rb.get("safe_dru_threshold", 1.0)),
            min_dru_diff=float(rb.get("min_dru_diff", 0.5)),
            max_preemption=int(rb.get("max_preemption", 100)),
            fast_cycle=bool(rb.get("fast_cycle", False)),
            gang_enabled=bool(rb.get("gang_enabled", True)),
            gang_max_admissions=int(rb.get("gang_max_admissions", 4)),
            gang_drain_max_wait_ms=float(
                rb.get("gang_drain_max_wait_ms", 300_000.0)),
            gang_drain_wasted_factor=float(
                rb.get("gang_drain_wasted_factor", 1.0)),
            resident=bool(rb.get("resident", False)),
        )
    # resident-mirror shorthands (docs/configuration.md): top-level
    # bools feeding the rebalancer / elastic `resident` knobs; an
    # explicit section-level `resident` wins
    if "resident_rebalancer" in data:
        rb = data.get("rebalancer")
        if not isinstance(rb, dict) or "resident" not in rb:
            settings.rebalancer.resident = bool(data["resident_rebalancer"])
    if "resident_elastic" in data and "resident" not in settings.elastic:
        settings.elastic["resident"] = bool(data["resident_elastic"])
    # always route through _match_config so the tuned hardware defaults
    # apply even when the operator config has no `match` section — a bare
    # config must not fall into the exact-kernel (chunk=0) perf trap
    settings.match = _match_config(data.get("match", {}))
    for ps in data.get("pool_schedulers", []):
        settings.pool_schedulers.append(
            PoolSchedulerConfig(
                pool_regex=ps["pool_regex"],
                match=_match_config(ps.get("match", {})),
            )
        )
    _validate(settings)
    return settings


def _validate(s: Settings) -> None:
    if not (0 < s.port < 65536):
        raise ValueError(f"bad port {s.port}")
    device_for_platform(s.platform)
    if not (0.0 < s.predictor_quantile <= 1.0):
        raise ValueError(f"bad predictor_quantile {s.predictor_quantile} "
                         "(expected (0, 1])")
    if s.backfill_weight < 0:
        raise ValueError(f"bad backfill_weight {s.backfill_weight}")
    for url in s.peers:
        if not str(url).startswith(("http://", "https://")):
            raise ValueError(f"bad peer url {url!r} (http(s)://... "
                             "required)")
    if s.journal_fsync_policy not in ("fail-stop", "degrade-async"):
        raise ValueError(
            f"bad journal_fsync_policy {s.journal_fsync_policy!r} "
            f"(fail-stop | degrade-async)")
    if s.match.scaleback <= 0 or s.match.scaleback > 1:
        raise ValueError(f"bad scaleback {s.match.scaleback}")
    if not s.pools:
        raise ValueError("at least one pool required")
    names = [p["name"] for p in s.pools]
    if len(names) != len(set(names)):
        raise ValueError("duplicate pool names")
