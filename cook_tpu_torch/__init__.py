"""cook-tpu-torch: the PyTorch/CUDA port of cook-tpu for an NVIDIA H100.

A second package beside `cook_tpu` (the JAX reference, which it never
imports).  Module paths and names follow `cook_tpu`, so each port file's
counterpart is obvious; every docstring names its reference file.  The
solver's tensor code is PyTorch on the device `device.resolve` picks
(CUDA unless the caller names the CPU), and each Pallas TPU kernel on the
ported path is a hand-written Hopper kernel under `csrc/`.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports, as `cook_tpu/__init__.py`'s (kept lazy so
    `import cook_tpu_torch` stays cheap and torch-free for clients that
    only need the REST client)."""
    if name in ("Job", "Instance", "Pool", "Resources"):
        from cook_tpu_torch.models import entities

        return getattr(entities, name)
    if name == "JobStore":
        from cook_tpu_torch.models.store import JobStore

        return JobStore
    if name == "Scheduler":
        from cook_tpu_torch.scheduler.core import Scheduler

        return Scheduler
    if name == "JobClient":
        from cook_tpu_torch.client import JobClient

        return JobClient
    if name == "Simulator":
        from cook_tpu_torch.sim.simulator import Simulator

        return Simulator
    raise AttributeError(f"module 'cook_tpu_torch' has no attribute {name!r}")
