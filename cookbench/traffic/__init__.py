"""Traffic mixes: one JSON file each, read by `generator.py`."""
