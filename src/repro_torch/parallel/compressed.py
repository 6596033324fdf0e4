"""Compressed tensor-parallel reduction: a row-parallel projection whose
partial sums cross the wire as int8 with per-row scales.

The port of ``repro/parallel/compressed.py``.  A row-parallel projection
y @ W with the contraction dim E split over the k ranks of the TP group
needs an all-reduce of the partial sums.  Here each rank quantizes its
float32 partial per row (the ``qpack`` kernel, a zero row scaling 1.0 as
the reference's ``_quantize_rows`` does), all-gathers the int8 payload and
the scales over the TP group, and dequant-sums locally (the ``qunpack``
kernel: sum over k of q_k * s_k in float32, cast to the output type).

Every rank holds the whole of ``y`` and ``w`` (the port shards no weights
yet, ROADMAP A7) and computes the partial of its own slice of E; the
output is replicated over the TP group, as the reference's is.  Without an
activation context, or where E % k or B % dp fails, it is a plain matmul.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.qpack import qpack, qunpack
from .actctx import _CTX

__all__ = ["rowparallel_einsum_compressed"]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rowparallel_einsum_compressed(y: torch.Tensor, w: torch.Tensor,
                                  out_dtype=None) -> torch.Tensor:
    """y: (B, S, E); w: (E, D).  Returns (B, S, D) as ``out_dtype``
    (default: y's), reduced through an int8 wire."""
    tp, dp = _CTX["tp"], _CTX["dp"]
    out_dtype = out_dtype or y.dtype
    B, S, E = y.shape
    k = _size(tp)
    if tp is None or E % k or B % _size(dp):
        return torch.matmul(y, w.to(y.dtype))
    lo = dist.get_rank(tp) * (E // k)
    hi = lo + E // k
    D = w.shape[1]
    # the partial must be float32 before its amax: bf16 products are exact
    # in float32, and a bf16 matmul would round the partial first
    part = torch.matmul(y[..., lo:hi].float(), w[lo:hi].to(y.dtype).float())
    q, s = qpack(part.reshape(B * S, D), zero_scale=1.0)
    # gathered flat, rank after rank (the layout gloo and NCCL both take)
    qg = torch.empty((k * B * S, D), dtype=torch.int8, device=y.device)
    sg = torch.empty((k * B * S, 1), dtype=torch.float32, device=y.device)
    dist.all_gather_into_tensor(qg, q, group=tp)
    dist.all_gather_into_tensor(sg, s, group=tp)
    return qunpack(qg.view(k, B * S, D), sg.view(k, B * S, 1),
                   out_dtype).reshape(B, S, D)
