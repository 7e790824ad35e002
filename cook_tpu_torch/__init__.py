"""cook-tpu-torch: the PyTorch/CUDA port of cook-tpu for an NVIDIA H100.

A second package beside `cook_tpu` (the JAX reference, which it never
imports).  Module paths and names follow `cook_tpu`, so each port file's
counterpart is obvious; every docstring names its reference file.  The
solver's tensor code is PyTorch on the device `device.resolve` picks
(CUDA unless the caller names the CPU), and each Pallas TPU kernel on the
ported path is a hand-written Hopper kernel under `csrc/`.
"""

__version__ = "0.1.0"
