"""The kind of a device operation by its kernel name, copied from
``chip_smoke.py``'s ``_kind`` (the split of its profiled train step)."""

from __future__ import annotations

_KINDS = (("gemm", ("gemm", "xmma", "nvjet", "cutlass")),
          ("reduce", ("reduce",)),
          ("index", ("index", "scatter", "gather")),
          ("elementwise", ("elementwise", "unrolled", "vectorized")),
          ("copy/fill", ("memcpy", "memset", "fill", "copy")))


def kind(name: str) -> str:
    n = name.lower()
    for k, keys in _KINDS:
        if any(key in n for key in keys):
            return k
    return "other"


def seconds_by_kind(kernels: dict) -> dict:
    """{kind: device seconds} of {kernel name: device seconds}."""
    out: dict = {}
    for name, s in kernels.items():
        k = kind(name)
        out[k] = out.get(k, 0.0) + s
    return out
