"""The operator tools: each module runs as `python -m
cook_tpu_torch.tools.<name>` with its reference's flags (`tools/<name>.py`
beside `cook_tpu/`) and output lines.  The tools that drive the scheduler
take `--device` (the card by default, `cpu` only when asked)."""
