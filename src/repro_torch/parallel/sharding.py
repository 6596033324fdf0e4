"""Logical-axis -> mesh-axis sharding rules, and their DTensor placements.

The port of ``repro/parallel/sharding.py``.  Every ParamSpec names its dims
with logical axes; one rule table maps those to mesh axes.  The rules are
divisibility-gated: a rule applies only when the dim divides evenly over
the mesh axis (the reference's strict gate: its in_shardings reject
padding).

Default layout ((data=16, model=16); multi-pod adds a leading "pod" DP
axis):

  TP ("model"):   heads, kv_heads, ff, vocab, mamba d_inner, rwkv fused
                  heads, expert d_ff
  DP ("pod","data"): batch dim of every activation / input
  ZeRO-3 ("data"): MoE expert dim E and, when ``zero3=True``, the largest
                  divisible dim of dense params
  ZeRO-1 ("data"): the largest still-unsharded divisible dim of the Adam
                  moments
  KV caches:      kv heads over "model" when divisible, else the time dim

A rule's result is spelled as the reference spells it, a
:class:`PartitionSpec`: one entry per dim, each ``None``, a mesh axis name,
or a tuple of names.  :func:`placements` turns ``(mesh, spec)`` into
DTensor placements, one per mesh dim.  The rules read only the mesh's
shape, so :func:`abstract_mesh` (sizes and names, no devices) is all they
need; a :class:`NamedSharding` pairs a ``DeviceMesh`` with a spec and is
what ``load_pytree(shardings=)`` and the dry run take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.specs import ParamSpec, map_logical

__all__ = ["ParallelismConfig", "PartitionSpec", "P", "AbstractMesh",
           "abstract_mesh", "NamedSharding", "mesh_shape", "placements",
           "local_shape", "logical_to_pspec", "param_shardings", "dp_spec",
           "batch_shardings", "cache_shardings", "opt_shardings", "shard_tensor"]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over all of them, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, no devices (the rules' input)."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an AbstractMesh or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


def placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i names it (alone or in a tuple), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in _names(mesh)]
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            out[_names(mesh).index(ax)] = Shard(i)
    return out


def local_shape(shape, mesh, spec) -> tuple:
    """The shape one rank holds of a ``shape`` tensor laid out by ``spec``
    (the rules shard only dims that divide evenly)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            if out[i] % sizes[ax]:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                                 f"over {ax!r} ({sizes[ax]})")
            out[i] //= sizes[ax]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` (or an AbstractMesh) and a PartitionSpec."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        return local_shape(shape, self.mesh, self.spec)


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """Per-run parallelism policy (independent of the model config)."""
    zero3: bool = False          # FSDP dense params over "data"
    zero1_moments: bool = True   # shard optimizer moments over "data" too
    shard_kv_cache_time: bool = True  # time-shard decode caches when kv%model!=0
    experts_fsdp: bool = True    # MoE expert dim over "data" (ZeRO-3 style)
    compressed_dp: bool = False  # int8 compressed DP grad reduction


# rule table: logical axis -> preferred mesh axis
_TP_RULES = {
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "inner": "model",       # mamba d_inner
    "inner2": "model",      # mamba in_proj fused (2*d_inner)
    "heads_d": "model",     # rwkv fused H*D
    "experts_r": None,      # router output: small, replicated
    "embed": None,          # activations replicated over model between layers
    "embed_o": None,
    "layers": None,         # the group-stack dim
}


def _divisible(dim: int, mesh, axis: str) -> bool:
    return dim % mesh_shape(mesh)[axis] == 0


def logical_to_pspec(spec: ParamSpec, mesh, pcfg: ParallelismConfig) -> PartitionSpec:
    """One ParamSpec -> PartitionSpec under the rule table."""
    names = _names(mesh)
    entries: list = []
    used = set()
    for dim, ax in zip(spec.shape, spec.axes):
        target: Optional[str] = None
        if ax == "experts" and pcfg.experts_fsdp and "data" in names:
            target = "data"
        else:
            rule = _TP_RULES.get(ax)
            # strict divisibility: kv = 8 heads or H = 40 on a 16-way model
            # axis stay replicated (decode caches shard over time instead)
            if rule and rule in names and rule not in used \
                    and _divisible(dim, mesh, rule):
                target = rule
        if target:
            used.add(target)
        entries.append(target)
    # ZeRO-3 for dense params: the largest unsharded divisible dim over
    # "data" (padding a ZeRO gather would move real bytes)
    if pcfg.zero3 and "data" in names and "data" not in used \
            and "experts" not in spec.axes and len(spec.shape) >= 2:
        cands = sorted(
            (i for i, e in enumerate(entries)
             if e is None and _divisible(spec.shape[i], mesh, "data")
             and spec.axes[i] != "layers"),
            key=lambda i: -spec.shape[i])
        if cands:
            entries[cands[0]] = "data"
    return P(*entries)


def param_shardings(model, mesh, pcfg: ParallelismConfig):
    """NamedSharding tree matching ``model.param_specs()``."""
    return map_logical(model.param_specs(),
                       lambda s: NamedSharding(mesh, logical_to_pspec(s, mesh, pcfg)))


def dp_spec(mesh, dim: int):
    """The DP axes if ``dim`` divides evenly over them, else None (replicate,
    e.g. global_batch = 1 long-context decode)."""
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in sizes if a != "model")
    size = 1
    for a in dp:
        size *= sizes[a]
    if dim % size:
        return None
    return dp if len(dp) > 1 else dp[0]


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (path: the keys down to it)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def batch_shardings(mesh, batch_tree):
    """Shard the leading (batch) dim of every input over all DP axes."""
    def one(_, x):
        ndim = len(x.shape)
        if not ndim:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(dp_spec(mesh, x.shape[0]),
                                     *([None] * (ndim - 1))))

    return _tree_map(one, batch_tree)


def cache_shardings(model, mesh, pcfg: ParallelismConfig, cache_tree):
    """Decode-state shardings, keyed on the cache tree's own structure.

    * attention kv ("self"/"cross" -> k/v (G,B,T,KV,Dh)): batch over DP;
      kv heads over model when divisible, else the TIME dim over model;
    * mamba ("ssm_state" -> conv (G,B,K-1,di) / ssm (G,B,di,n)): d_inner
      over model;
    * rwkv ("tm_state" (G,B,H,Dk,Dv)): heads over model; shift states
      (G,B,d): d over model.
    Divisibility-gated throughout."""
    msize = mesh_shape(mesh)["model"]

    def shard_dim(shape, i):
        return "model" if shape[i] % msize == 0 else None

    def one(keys, leaf):
        shape = leaf.shape
        dp = dp_spec(mesh, shape[1])   # dim 1 = batch (dim 0 = groups)
        if "self" in keys or "cross" in keys:      # (G,B,T,KV,Dh)
            if shape[3] % msize == 0:
                return NamedSharding(mesh, P(None, dp, None, "model", None))
            if pcfg.shard_kv_cache_time and shape[2] % msize == 0:
                return NamedSharding(mesh, P(None, dp, "model", None, None))
            return NamedSharding(mesh, P(None, dp, None, None, None))
        if "conv" in keys:                          # (G,B,K-1,di)
            return NamedSharding(mesh, P(None, dp, None, shard_dim(shape, 3)))
        if "ssm" in keys:                           # (G,B,di,n)
            return NamedSharding(mesh, P(None, dp, shard_dim(shape, 2), None))
        if "tm_state" in keys:                      # (G,B,H,Dk,Dv)
            return NamedSharding(mesh, P(None, dp, shard_dim(shape, 2), None, None))
        if len(shape) == 3:                         # shifts (G,B,d)
            return NamedSharding(mesh, P(None, dp, shard_dim(shape, 2)))
        return NamedSharding(mesh, P(*([None] * len(shape))))

    return _tree_map(one, cache_tree)


def opt_shardings(model, mesh, pcfg: ParallelismConfig):
    """Adam moments: like params, plus ZeRO-1 sharding of the largest
    still-unsharded divisible dim over "data"."""
    sizes = mesh_shape(mesh)

    def one(spec: ParamSpec):
        entries = list(logical_to_pspec(spec, mesh, pcfg))
        if pcfg.zero1_moments and "data" in sizes and "data" not in entries:
            cands = sorted(
                (i for i, e in enumerate(entries)
                 if e is None and spec.shape[i] % sizes["data"] == 0),
                key=lambda i: -spec.shape[i])
            if cands:
                entries[cands[0]] = "data"
        return NamedSharding(mesh, P(*entries))

    return map_logical(model.param_specs(), one)


def shard_tensor(full: torch.Tensor, sharding: NamedSharding):
    """A DTensor laid out by ``sharding`` from a tensor every rank holds in
    full: each rank keeps its own shard (no collective), copied out so the
    full tensor can be dropped."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    dt = distribute_tensor(full, sharding.mesh, sharding.placements,
                           src_data_rank=None)
    local = dt.to_local()
    if local.numel() < full.numel() and \
            local.untyped_storage().data_ptr() == full.untyped_storage().data_ptr():
        local = local.clone()
        dt = DTensor.from_local(local, sharding.mesh, dt.placements,
                                run_check=False, shape=dt.shape,
                                stride=dt.stride())
    return dt
