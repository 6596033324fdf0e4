"""Kernels: device ms a train step in kernels the classifier calls
elementwise (the step's eager passes), from the profiler's trace."""

from portbench.kinds import seconds_by_kind


def read(seen):
    r = seen.records
    if r.get("kind") != "train" or not r["steps"] or not seen.kernels:
        return None
    return seconds_by_kind(seen.kernels).get("elementwise", 0.0) / r["steps"] * 1e3
