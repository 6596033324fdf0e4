"""The model's functions that do not run as DTensor ops under a mesh: the
embedding lookup, the shift along time, the attention core and the
cross-entropy.  Each runs as a local function on this rank's shards, with
its own TP collectives; without a mesh context each is the plain
function, unchanged.

* :func:`embed_lookup` is a vocab-parallel lookup: each rank looks up the
  tokens its slice of the vocab holds, zeros elsewhere, and the rows are
  summed over TP.  DTensor's own ``index`` over a batch split on two mesh
  dims, and its backward's ``index_put``, have no rule in some versions.
* :func:`shift_time` (rwkv's token shift, mamba's causal conv): a
  DTensor's ``pad`` fails to plan its redistribution in some versions.
* :func:`attention_core` runs a core that is local over batch and kv
  heads.  Where TP splits the kv heads, each rank takes its heads.  Where
  it splits the query heads but not the kv heads, each rank takes its
  query heads and, for each, its kv head (a view of a head dim into (KV,
  G) with KV < TP is one DTensor cannot split).  A decode over a cache
  whose time dim is split over TP (``cache_shardings``' KV-time rule)
  attends over this rank's slice and combines the softmax over the
  group, as a flash-decode does.
* :func:`xent_parts` is a vocab-parallel cross-entropy: each rank reduces
  its slice of the vocab and the parts are summed over TP.  DTensor's own
  gather over a split vocab leaves a masked partial it cannot reduce.

The sums go through :func:`_all_reduce`, whose backward passes the
gradient through unchanged: every TP rank holds the same reduced value
and seeds the same gradient, so a backward all-reduce would count it k
times.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .actctx import _CTX, _local, _spec, shard_map, tp_size

__all__ = ["embed_lookup", "shift_time", "attention_core", "xent_parts"]


class _AllReduce(torch.autograd.Function):
    """An all-reduce over ``group`` whose backward is the identity (the
    gradient of a value every rank holds whole)."""

    @staticmethod
    def forward(ctx, x, op, group):
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_reduce(x, op=dist.ReduceOp.SUM):
    return _AllReduce.apply(x, op, _CTX["tp"])


def _vocab_start(vl: int) -> int:
    """The first vocab row of this rank's TP slice of ``vl`` rows."""
    return _CTX["mesh"].get_local_rank(_CTX["tp_axis"]) * vl


def embed_lookup(table, tokens):
    """``table[tokens]``: (V, d) rows for an integer ``tokens`` of any
    shape, its first dim the batch."""
    if _CTX["mesh"] is None:
        return table[tokens]

    def lookup(tab, tok):
        vl = tab.shape[0]
        if vl == table.shape[0]:
            return tab[tok]
        lo = _vocab_start(vl)
        inside = (tok >= lo) & (tok < lo + vl)
        rows = tab[(tok - lo).clamp(0, vl - 1)] * inside[..., None].to(tab.dtype)
        return _all_reduce(rows)

    shape = tuple(tokens.shape) + (table.shape[1],)
    return shard_map(lookup, (table, tokens), (("tp", None), ("dp",)),
                     out_like=(shape, ("dp",)))


def shift_time(x, k: int = 1):
    """x (B, S, C) moved k steps later along S, zeros first."""
    def shift(t):
        return F.pad(t, (0, 0, k, 0))[:, :-k]

    if _CTX["mesh"] is None:
        return shift(x)
    return shard_map(shift, (x,), (("dp", None, "tp"),))


def _over_split_time(scores, q5, v):
    """The softmax over this rank's slice of the keys, combined over the TP
    group: the rows' maxima, sums and weighted values are all-reduced."""
    s = scores(q5)                                        # (b, kv, g, s, t)
    m = _all_reduce(torch.amax(s, dim=-1, keepdim=True), dist.ReduceOp.MAX)
    p = torch.exp(s - m.clamp_min(-1e30))
    denom = _all_reduce(torch.sum(p, dim=-1, keepdim=True))
    o = _all_reduce(torch.einsum("bkgst,btkd->bskgd", p, v.float()))
    return o / denom.clamp_min(1e-30).permute(0, 3, 1, 2, 4)


def attention_core(core, q, k, v, rest=(), rest_kinds=(), scores=None):
    """(B, S, H, Dh) float32 from ``core(q5, k, v, *rest)`` -> (B, S, KV,
    G, Dh), with q5 = q (B, S, H, Dh) grouped as (B, S, KV, G, Dh) and k, v
    (B, T, KV, Dh);
    ``rest`` are further arguments laid out by ``rest_kinds`` (as
    ``constrain``'s kinds).  The core must be local over batch and kv
    heads.

    ``scores(q5, k, bias)`` -> the biased scores (B, KV, G, S, T), given
    only for a decode over a cache, whose ``rest`` is its (B, S, T) bias:
    under a mesh that splits neither head dim of the kv but the cache's
    time, the softmax is combined over TP from the scores."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]

    def grouped(q, k, v, *r):
        b, s, h, dh = q.shape
        return core(q.reshape(b, s, k.shape[2], h // k.shape[2], dh), k, v, *r)

    if _CTX["mesh"] is None:
        return grouped(q, k, v, *rest).flatten(2, 3)
    tp = tp_size()
    heads = ("dp", None, "tp")
    if KV % tp == 0 or H % tp:
        return shard_map(grouped, (q, k, v, *rest), (heads,) * 3 + tuple(rest_kinds),
                         out_like=((B, S, KV, H // KV, Dh), heads)).flatten(2, 3)
    if scores is not None and k.shape[1] % tp == 0:
        def over_time(q, k, v, bias):
            b = q.shape[0]
            return _over_split_time(lambda q5: scores(q5, k, bias),
                                    q.reshape(b, S, KV, H // KV, Dh), v)
        return shard_map(over_time, (q, k, v, *rest),
                         (("dp",), ("dp", "tp"), ("dp", "tp"), ("dp", None, "tp")),
                         out_like=((B, S, KV, H // KV, Dh), ("dp",))).flatten(2, 3)

    def per_head(q, k, v, *r):
        # this rank's query heads, each with its own kv head
        h = q.shape[2]
        lo = _CTX["mesh"].get_local_rank(_CTX["tp_axis"]) * h
        kv = torch.arange(lo, lo + h, device=k.device) // (H // KV)
        return core(q.unsqueeze(3), k.index_select(2, kv), v.index_select(2, kv), *r)

    # k and v whole on every TP rank: their gradient is a partial sum
    return shard_map(per_head, (q, k, v, *rest),
                     (heads, ("dp",), ("dp",)) + tuple(rest_kinds),
                     out_like=((B, S, H, 1, Dh), heads)).flatten(2, 3)


def _xent_plain(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse, tgt, logits.argmax(-1) == targets


def xent_parts(logits, targets):
    """Per position: the logsumexp over the vocab, the target's logit, and
    whether the argmax (the first, on a tie) is the target.  Under a mesh
    that splits the vocab over TP, each rank reduces its slice and the
    parts are combined over the TP group."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return _xent_plain(logits, targets)
    from torch.distributed.tensor import DTensor
    from .sharding import placements
    B, c, V = logits.shape
    lg = _local(logits, mesh, placements(mesh, _spec(logits.shape, ("dp", None, "tp"))))
    t = _local(targets, mesh, placements(mesh, _spec(targets.shape, ("dp",)))).long()
    Vl = lg.shape[-1]
    if Vl == V:
        lse, tgt, hit = _xent_plain(lg, t)
    else:
        lo = _vocab_start(Vl)
        m_l, i_l = lg.detach().max(-1)
        m = _all_reduce(m_l, dist.ReduceOp.MAX)
        lse = torch.log(_all_reduce(torch.exp(lg - m[..., None]).sum(-1))) + m
        inside = (t >= lo) & (t < lo + Vl)
        tl = torch.gather(lg, -1, (t - lo).clamp(0, Vl - 1)[..., None])[..., 0]
        tgt = _all_reduce(torch.where(inside, tl, torch.zeros_like(tl)))
        first = _all_reduce(torch.where(m_l == m, i_l + lo, torch.full_like(i_l, V)),
                            dist.ReduceOp.MIN)
        hit = first == t
    pl = placements(mesh, _spec((B, c), ("dp",)))
    return tuple(DTensor.from_local(x, mesh, pl, run_check=False,
                                    shape=torch.Size((B, c)), stride=(c, 1))
                 for x in (lse, tgt, hit))
