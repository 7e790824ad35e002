"""The port's service configuration (`cook_tpu_torch/utils/config.py`)
against the reference's on the CPU: `read_config` of both packages on the
repo's examples/config.json, on a config with every section set, and on
tests/test_components.py's configs gives equal settings (the match
section less the reference's fallback-ladder keys, which the port drops);
the port's `platform` names its device; validation refuses the same
inputs."""
import dataclasses
import json
import os

import pytest
import torch

from cook_tpu.utils import config as ref_config
from cook_tpu_torch import device as port_device
from cook_tpu_torch.utils import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = pytest.mark.parametrize("cfg", [ref_config, port_config],
                               ids=["ref", "port"])
# the reference's CPU fallback ladder: read by its config, absent from the
# port's MatchConfig by design
LADDER = {"device_fallback_cycles", "device_latency_guard"}

EVERY_SECTION = {
    "port": 4242, "default_pool": "batch", "mea_culpa_failure_limit": 7,
    "rank_interval_s": 0.5, "match_interval_s": 0.25,
    "rebalancer_interval_s": 9.0, "optimizer_interval_s": 30.0,
    "leader_lease_path": "", "leader_group": "g", "leader_ttl_s": 4.0,
    "advertised_url": "http://x:1", "replication_user": "repl",
    "replication_min_acks": 2, "replication_ack_timeout_s": 1.5,
    "replication_ack_liveness_s": 12.0, "data_dir": "/tmp/cook-data",
    "snapshot_interval_s": 60.0, "platform": "cpu", "shards": 1,
    "replica_reads": False, "replica_staleness_ceiling_ms": 100.0,
    "replica_refuse_after_s": 3.0, "batched_match": True,
    "pipelined_match": True, "speculation": True,
    "speculation_horizon_ms": 5000.0, "predictor_quantile": 0.9,
    "predictor_window": 16, "predictor_min_samples": 2,
    "backfill_weight": 0.25, "backfill_norm_ms": 100000.0,
    "elastic_interval_s": 15.0, "fault_injection": True,
    "journal_fsync_policy": "degrade-async", "load_shedding": False,
    "incident_dir": "/tmp/inc", "incident_capacity": 8,
    "incident_cooldown_s": 2.0, "health_watch_interval_s": 1.0,
    "auto_profile": False, "profile_dir": "/tmp/prof",
    "history_sample_s": 2.0, "fleet_poll_s": 0.0,
    "queue_limit_per_pool": 5000, "queue_limit_per_user": 500,
    "submission_rate_per_minute": 600.0,
    "admins": ["root", "ops"], "cors_origins": ["https://d.example"],
    "auth": {"kind": "basic"}, "executor_token": "tok",
    "plugins": {"pool_mover": {}}, "api": {"max_gang_size": 16},
    "peers": ["http://peer:1"],
    "history_retention": {"raw_points": 100},
    "pools": [{"name": "batch"}, {"name": "gpu", "dru_mode": "gpu"}],
    "clusters": [{"kind": "mock", "name": "m", "hosts": []}],
    "rebalancer": {"safe_dru_threshold": 0.8, "min_dru_diff": 0.2,
                   "max_preemption": 7, "fast_cycle": True,
                   "gang_enabled": False, "gang_max_admissions": 2,
                   "gang_drain_max_wait_ms": 1000.0,
                   "gang_drain_wasted_factor": 2.0},
    "elastic": {"headroom": 0.2, "rank_half_life": 8,
                "reclaim_window": 10, "count_block_headroom": False,
                "gang_block_hosts": 4},
    "resident_rebalancer": True, "resident_elastic": True,
    "match": {"max_jobs_considered": 16384, "scaleback": 0.9,
              "chunk": 1024, "chunk_rounds": 2, "chunk_passes": 4,
              "chunk_kc": 32, "backend": "pallas",
              "quality_audit_every": 7, "completion_multiplier": 1.5,
              "host_lifetime_mins": 60.0, "agent_start_grace_mins": 3.0,
              "checkpoint_memory_overhead_mb": 64.0,
              "device_fallback_cycles": 3, "device_latency_guard": 2.0,
              "hierarchical_threshold": 1,
              "hierarchical_nodes_per_block": 512,
              "hierarchical_jobs_per_block": 256,
              "hierarchical_refine_rounds": 3,
              "hier_superblock_nodes": 4096,
              "hierarchical_coarse_backend": "pallas",
              "hierarchical_use_mesh": False,
              "hierarchical_fine_backend": "pallas",
              "device_residency": True, "quantized": True,
              "quantization_parity_floor": 0.9, "gang_enabled": False,
              "topology_weight": 0.5, "topology_block_hosts": 8},
    "pool_schedulers": [{"pool_regex": "gp.*",
                         "match": {"max_jobs_considered": 5}}],
}


def as_dict(settings) -> dict:
    """Settings as plain data: nested dataclasses flattened, the
    reference's ladder keys dropped (from every MatchConfig)."""
    d = dataclasses.asdict(settings)
    for m in [d["match"]] + [ps["match"] for ps in d["pool_schedulers"]]:
        for key in LADDER:
            m.pop(key, None)
    return d


def both(path=None, overrides=None):
    return (as_dict(ref_config.read_config(path, overrides)),
            as_dict(port_config.read_config(path, overrides)))


def test_example_config_reads_the_same():
    ref, port = both(os.path.join(REPO, "examples", "config.json"))
    assert port == ref
    assert port["match"]["chunk"] == 0          # explicit beats tuned
    assert port["clusters"][0]["name"] == "local-sim"


def test_defaults_read_the_same():
    ref, port = both()
    assert port == ref
    # a bare config gets the repo's tuned matcher defaults
    assert port["match"]["chunk"] == 1024 and port["match"]["chunk_kc"] == 64


def test_every_section_reads_the_same(tmp_path):
    path = tmp_path / "every.json"
    path.write_text(json.dumps(EVERY_SECTION))
    ref, port = both(str(path))
    assert port == ref
    # the sections landed, not the defaults
    assert port["match"]["quantization_parity_floor"] == 0.9
    assert port["match"]["hierarchical_superblock_nodes"] == 4096
    assert port["rebalancer"]["resident"] is True
    assert port["elastic"]["resident"] is True
    assert port["pool_schedulers"][0]["match"]["max_jobs_considered"] == 5
    s = port_config.read_config(str(path))
    assert s.match_config_for_pool("gpu").max_jobs_considered == 5
    assert s.match_config_for_pool("batch").max_jobs_considered == 16384
    assert not hasattr(s.match, "device_fallback_cycles")


@PKGS
def test_shorthands_lose_to_explicit_sections(cfg, tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({
        "rebalancer": {"resident": False}, "elastic": {"resident": False},
        "resident_rebalancer": True, "resident_elastic": True}))
    s = cfg.read_config(str(path))
    assert s.rebalancer.resident is False
    assert s.elastic["resident"] is False


@PKGS
@pytest.mark.parametrize("bad", [
    {"port": -1},
    {"pools": [{"name": "x"}, {"name": "x"}]},
    {"pools": []},
    {"predictor_quantile": 0.0},
    {"backfill_weight": -1},
    {"peers": ["ftp://x"]},
    {"journal_fsync_policy": "sometimes"},
    {"match": {"scaleback": 0}},
], ids=["port", "dup-pools", "no-pools", "quantile", "backfill", "peer",
        "fsync", "scaleback"])
def test_validation_refuses(cfg, bad, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        cfg.read_config(str(path))


def test_platform_names_the_port_device(tmp_path, monkeypatch):
    assert port_config.device_for_platform("cpu") == "cpu"
    assert port_config.device_for_platform("") is None
    with pytest.raises(ValueError, match="platform"):
        port_config.device_for_platform("tpu")
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"platform": "tpu"}))
    with pytest.raises(ValueError, match="platform"):
        port_config.read_config(str(path))
    # "" is the card: without one it raises instead of serving from the
    # CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve(port_config.device_for_platform(""))


def test_parity_floor_reaches_the_resident_state():
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.device_state import (
        QUANTIZATION_PARITY_FLOOR)

    assert port_config.default_match_config().quantization_parity_floor \
        == QUANTIZATION_PARITY_FLOOR == \
        ref_config.default_match_config().quantization_parity_floor
    match = port_config.default_match_config(quantized=True,
                                             quantization_parity_floor=0.5)
    scheduler = Scheduler(JobStore(), [], SchedulerConfig(match=match),
                          device="cpu")
    state = scheduler.device_state
    assert state.parity_floor == 0.5
    state._quant_armed.add("p")
    state.note_quality("p", 0.6)
    assert state.demoted_pools() == []
    state.note_quality("p", 0.4)
    assert state.demoted_pools() == ["p"]
