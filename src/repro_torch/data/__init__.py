"""Synthetic workloads (numpy)."""
from .generators import MovingObjectWorkload, WorkloadConfig, make_workload

__all__ = ["MovingObjectWorkload", "WorkloadConfig", "make_workload"]
