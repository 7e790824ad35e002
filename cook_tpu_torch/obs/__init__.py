"""Observability of the port: the fairness observatory and its baseline."""
