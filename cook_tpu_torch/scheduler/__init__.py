"""Rank, match and launch: the scheduler host layer."""
