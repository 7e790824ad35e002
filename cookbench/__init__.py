"""The benchmark of the PyTorch and CUDA scheduler, `cook_tpu_torch`
(see README.md; entry point `run.py`)."""
