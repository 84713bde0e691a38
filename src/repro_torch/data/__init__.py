"""Synthetic workloads (numpy)."""
