"""Runnable recipes: each module runs as `python -m
cook_tpu_torch.examples.<name>` (the reference's `examples/<name>.py`)."""
