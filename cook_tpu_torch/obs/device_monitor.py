"""Live device-memory gauges and the OOM-risk probe.

Port of `cook_tpu/obs/device_monitor.py`, with the same gauge names.  On a
CUDA device the stats come from PyTorch's caching allocator
(`torch.cuda.memory_stats`: the bytes of live tensors and their peak) and
the card's capacity (`torch.cuda.mem_get_info`, read once per device: the
capacity does not change, and the allocator stats are host-side counters,
so a refresh after every solve adds no device sync).  On the CPU there are
no such stats: the gauges are not set and the OOM-risk check reports
"unobservable" rather than healthy-by-default, as the reference does where
its device reports none.

A 100k x 10k match problem's [J, N] constraint mask alone is ~2 GB of
device memory — the scheduler can genuinely OOM a shared device."""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from cook_tpu_torch.utils.metrics import global_registry


@functools.lru_cache(maxsize=None)
def _capacity_bytes(index: int) -> int:
    return int(torch.cuda.mem_get_info(index)[1])


def device_memory_stats(
        device: Optional[Union[str, torch.device]] = None) -> Optional[dict]:
    """{bytes_in_use, bytes_limit, peak_bytes_in_use, utilization} for
    `device` (default: the current CUDA device), or None on the CPU or
    when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    in_use = float(stats.get("allocated_bytes.all.current", 0))
    limit = float(_capacity_bytes(index))
    return {
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                             in_use)),
        "utilization": (in_use / limit) if limit > 0 else 0.0,
    }


def update_device_memory_gauges(stats_provider=device_memory_stats,
                                ) -> Optional[dict]:
    """Refresh the device-memory gauges from `stats_provider` and return
    its stats dict (None when unobservable).  Called after every device
    solve."""
    stats = stats_provider()
    if stats is None:
        return None
    g = global_registry.gauge
    g("obs.device.mem_bytes_in_use",
      "device allocator bytes currently in use").set(stats["bytes_in_use"])
    g("obs.device.mem_bytes_limit",
      "device allocator capacity in bytes").set(stats["bytes_limit"])
    g("obs.device.mem_peak_bytes",
      "high-water device allocator bytes").set(stats["peak_bytes_in_use"])
    g("obs.device.mem_utilization",
      "device memory fill fraction (in_use / limit)").set(
        stats["utilization"])
    return stats
