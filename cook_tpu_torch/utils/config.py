"""Matcher configuration defaults.

Port of `default_match_config` (and the `tuned_match_defaults` it reads)
from `cook_tpu/utils/config.py`: dataclass defaults merged under the
hardware-tuned `tuned_match.json` at the repo root (read as data) and any
explicit overrides.  The service settings are a later slice.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

from cook_tpu_torch.scheduler.matcher import MatchConfig

log = logging.getLogger(__name__)


def tuned_match_defaults(path: Optional[str] = None) -> dict:
    """The tuned matcher defaults, in MatchConfig field names.

    Exactly ONE source is consulted: the `path` arg when given; otherwise
    $COOK_TUNED_MATCH when set (""/"none"/"off" disables tuned defaults
    entirely); otherwise the repo-root tuned_match.json.  Returns {} when
    the consulted source is absent or unreadable."""
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
            log.warning("tuned match config %s exists but is unusable "
                        "(%s); falling back to untuned defaults", p, e)
            continue
        if not isinstance(loaded, dict):
            log.warning("tuned match config %s is not a JSON object; "
                        "falling back to untuned defaults", p)
            continue
        # the sweep writes rounds/passes/kc; translate to field names
        out = {}
        for src, dst in (("chunk", "chunk"), ("rounds", "chunk_rounds"),
                         ("passes", "chunk_passes"), ("kc", "chunk_kc"),
                         ("backend", "backend")):
            if src in loaded:
                out[dst] = loaded[src]
        return out
    return {}


def default_match_config(**overrides) -> MatchConfig:
    """The sim default matcher config: the reference's config-file defaults
    merged under the tuned defaults and any explicit overrides (highest
    precedence)."""
    d = {**tuned_match_defaults(), **overrides}
    return MatchConfig(
        max_jobs_considered=int(d.get("max_jobs_considered", 1000)),
        scaleback=float(d.get("scaleback", 0.95)),
        chunk=int(d.get("chunk", 0)),
        chunk_rounds=int(d.get("chunk_rounds", 6)),
        chunk_passes=int(d.get("chunk_passes", 2)),
        chunk_kc=int(d.get("chunk_kc", 128)),
        backend=str(d.get("backend", "xla")),
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
        # primary key `hier_superblock_nodes`; the long form is an alias
        hierarchical_superblock_nodes=int(
            d.get("hier_superblock_nodes",
                  d.get("hierarchical_superblock_nodes", 0))),
        hierarchical_coarse_backend=str(
            d.get("hierarchical_coarse_backend", "xla")),
        hierarchical_use_mesh=bool(d.get("hierarchical_use_mesh", True)),
        hierarchical_fine_backend=str(
            d.get("hierarchical_fine_backend", "xla")),
        # device-resident match state + quantized cost tensors
        # (scheduler/device_state.py)
        device_residency=bool(d.get("device_residency", False)),
        quantized=bool(d.get("quantized", False)),
        # topology-aware gang scheduling (scheduler/gang.py; the match
        # chokepoint in finalize_pool_match)
        gang_enabled=bool(d.get("gang_enabled", True)),
        topology_weight=float(d.get("topology_weight", 0.0)),
        topology_block_hosts=int(d.get("topology_block_hosts", 0)),
    )

