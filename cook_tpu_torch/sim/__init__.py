"""The trace-replay simulator and its CLI."""
