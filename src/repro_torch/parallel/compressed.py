"""Compressed tensor-parallel reduction: a row-parallel projection whose
partial sums cross the wire as int8 with per-row scales.

The port of ``repro/parallel/compressed.py``.  A row-parallel projection
y @ W with the contraction dim E split over the k ranks of the TP group
needs an all-reduce of the partial sums.  Here each rank quantizes its
float32 partial per row (the ``qpack`` kernel, a zero row scaling 1.0 as
the reference's ``_quantize_rows`` does), all-gathers the int8 payload and
the scales over the TP group, and dequant-sums locally (the ``qunpack``
kernel: sum over k of q_k * s_k in float32, cast to the output type).

Two layouts, after the two forms of the activation context:

* under a ``DeviceMesh`` context, a DTensor ``y`` is laid out as the
  reference's shard_map ``in_specs`` say, ``P(dp, None, tp)``, and ``w`` as
  ``P(tp, None)``: a DTensor (redistributed there if it is not), or a
  plain tensor, either whole ``(E, D)`` or this rank's ``(E/k, D)`` rows.
  The result is a DTensor ``P(dp, None, None)``: batch over DP, replicated
  over TP, as the reference's ``out_specs``;
* otherwise (a plain ``y``, under either context) every rank holds the
  whole of ``y`` and computes the partial of its own slice of E, with
  ``w`` whole or this rank's rows; the result is replicated over the group.

Without a context, or where E % k or B % dp fails, it is a plain matmul.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.qpack import qpack, qunpack
from .actctx import _CTX

__all__ = ["rowparallel_einsum_compressed"]


def _reduce(y_loc, w_loc, group, k: int, out_dtype):
    """(b, s, E/k) @ (E/k, D) partials -> the (b, s, D) sum over the group,
    through qpack -> two all-gathers -> qunpack."""
    b, s, _ = y_loc.shape
    D = w_loc.shape[1]
    # the partial must be float32 before its amax: bf16 products are exact
    # in float32, and a bf16 matmul would round the partial first
    part = torch.matmul(y_loc.float(), w_loc.to(y_loc.dtype).float())
    q, sc = qpack(part.reshape(b * s, D), zero_scale=1.0)
    # gathered flat, rank after rank (the layout gloo and NCCL both take)
    qg = torch.empty((k * b * s, D), dtype=torch.int8, device=y_loc.device)
    sg = torch.empty((k * b * s, 1), dtype=torch.float32, device=y_loc.device)
    dist.all_gather_into_tensor(qg, q, group=group)
    dist.all_gather_into_tensor(sg, sc, group=group)
    return qunpack(qg.view(k, b * s, D), sg.view(k, b * s, 1),
                   out_dtype).reshape(b, s, D)


def _rows(w, E: int, k: int, rank: int):
    """This rank's (E/k, D) rows of a whole ``w``; a ``w`` of E/k rows is
    taken as those rows already."""
    if w.shape[0] == E:
        return w[rank * (E // k):(rank + 1) * (E // k)]
    if w.shape[0] * k != E:
        raise ValueError(f"w has {w.shape[0]} rows: neither E = {E} nor "
                         f"E / k = {E // k}")
    return w


def _on_mesh(y, w, out_dtype):
    from torch.distributed.tensor import DTensor
    from .sharding import P, placements
    mesh, tp, dp = y.device_mesh, _CTX["tp_axis"], _CTX["dp_axes"]
    names = tuple(mesh.mesh_dim_names)
    k = mesh.size(names.index(tp))
    B, S, E = y.shape
    D = w.shape[1]
    dps = (dp if len(dp) > 1 else dp[0]) if dp else None
    if E % k or B % _CTX["dp_size"]:
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, mesh, placements(mesh, P(None, None)),
                                   run_check=False)
        return torch.matmul(y, w.to(y.dtype))
    y_loc = y.redistribute(mesh, placements(mesh, P(dps, None, tp))).to_local()
    rank = mesh.get_local_rank(tp)
    if isinstance(w, DTensor):
        w_loc = w.redistribute(mesh, placements(mesh, P(tp, None))).to_local()
    else:
        w_loc = _rows(w, E, k, rank)
    out = _reduce(y_loc, w_loc, mesh.get_group(tp), k, out_dtype)
    return DTensor.from_local(out, mesh, placements(mesh, P(dps, None, None)),
                              run_check=False, shape=torch.Size((B, S, D)),
                              stride=(S * D, D, 1))


def rowparallel_einsum_compressed(y: torch.Tensor, w: torch.Tensor,
                                  out_dtype=None) -> torch.Tensor:
    """y: (B, S, E); w: (E, D) (or this rank's (E/k, D) rows).  Returns
    (B, S, D) as ``out_dtype`` (default: y's), reduced through an int8
    wire."""
    from torch.distributed.tensor import DTensor
    out_dtype = out_dtype or y.dtype
    if isinstance(y, DTensor) and _CTX["tp_axis"] is not None:
        return _on_mesh(y, w, out_dtype)
    tp = _CTX["tp"]
    B, S, E = y.shape
    k = 1 if tp is None else dist.get_world_size(tp)
    if tp is None or E % k or B % _CTX["dp_size"]:
        return torch.matmul(y, w.to(y.dtype))
    lo = dist.get_rank(tp) * (E // k)
    return _reduce(y[..., lo:lo + E // k], _rows(w, E, k, dist.get_rank(tp)),
                   tp, k, out_dtype)
