"""Domain entities, the state machine and the job store (copies of `cook_tpu.models`)."""
