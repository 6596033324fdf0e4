"""Kernels: device ms a train step in GEMM kernels (cuBLAS; the float32
unembedding among them), from the profiler's trace."""

from portbench.kinds import seconds_by_kind


def read(seen):
    r = seen.records
    if r.get("kind") != "train" or not r["steps"] or not seen.kernels:
        return None
    return seconds_by_kind(seen.kernels).get("gemm", 0.0) / r["steps"] * 1e3
