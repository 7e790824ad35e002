"""The one place the port picks its device.

Every entry point (the scheduler, the simulator, the CLI) resolves its
device here.  The default is the CUDA card; the CPU is used only when the
caller names it.  With no card and no explicit `device="cpu"` this raises:
a run that silently dropped to the CPU would report host numbers as the
card's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as a `torch.device` ("cuda" when None); raises when CUDA is
    asked for and `torch.cuda.is_available()` is False."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cook_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda | cpu)")
    return dev
