"""Activation context: the process groups, and the mesh, that model code
reduces and lays out activations over.

The reference's context holds a JAX mesh and names its TP axis
(``repro/parallel/actctx.py``).  Here it takes either form:

* ``activation_context(mesh, tp_axis="model")`` with a ``DeviceMesh``: the
  TP group is the mesh's ``tp_axis`` dim, the DP axes are the others, and
  ``constrain`` lays DTensor activations out as the reference's
  ``with_sharding_constraint`` does;
* ``activation_context(tp_group, dp_group=None)`` with ``torch.distributed``
  process groups (no mesh): the collectives' groups only.

Model code reads it through ``_CTX``.  ``constrain`` of a plain tensor is
a no-op, so the eager path runs exactly as without a context.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["set_activation_context", "clear_activation_context", "constrain",
           "activation_context", "one_rank_group", "tp_size", "shard_map",
           "write_slots", "gather_weights"]

# tp/dp: the process groups; dp_size: the DP world (the product of the DP
# mesh dims, or the dp group's size); mesh, tp_axis, dp_axes: mesh form only
_CTX: dict = {"tp": None, "dp": None, "dp_size": 1, "mesh": None,
              "tp_axis": None, "dp_axes": ()}


def _is_mesh(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x, DeviceMesh)


def set_activation_context(tp, dp=None, tp_axis: str = "model") -> None:
    if _is_mesh(tp):
        mesh, names = tp, tuple(tp.mesh_dim_names)
        dp_axes = tuple(a for a in names if a != tp_axis)
        dp_size = 1
        for a in dp_axes:
            dp_size *= mesh.size(names.index(a))
        _CTX.update(tp=mesh.get_group(tp_axis) if tp_axis in names else None,
                    dp=None, dp_size=dp_size, mesh=mesh,
                    tp_axis=tp_axis if tp_axis in names else None,
                    dp_axes=dp_axes)
        return
    _CTX.update(tp=tp, dp=dp,
                dp_size=1 if dp is None else dist.get_world_size(dp),
                mesh=None, tp_axis=None, dp_axes=())


def clear_activation_context() -> None:
    _CTX.update(tp=None, dp=None, dp_size=1, mesh=None, tp_axis=None,
                dp_axes=())


class activation_context:
    def __init__(self, tp, dp=None, tp_axis: str = "model"):
        self.tp, self.dp, self.tp_axis = tp, dp, tp_axis

    def __enter__(self):
        set_activation_context(self.tp, self.dp, self.tp_axis)

    def __exit__(self, *a):
        clear_activation_context()


def _axis_size(mesh, axes) -> int:
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= mesh.size(names.index(a))
    return n


def tp_size() -> int:
    """The TP mesh dim's size under a mesh context, else 1."""
    mesh = _CTX["mesh"]
    return 1 if mesh is None or _CTX["tp_axis"] is None else \
        _axis_size(mesh, _CTX["tp_axis"])


def _spec(shape, kinds):
    """The reference's constraint for ``kinds`` on a ``shape`` tensor, as
    a PartitionSpec (divisibility-gated)."""
    from .sharding import P
    mesh, dp, tp = _CTX["mesh"], _CTX["dp_axes"], _CTX["tp_axis"]
    entries = []
    for i, dim in enumerate(shape):
        kind = kinds[i] if i < len(kinds) else None
        ax = None
        if kind == "dp" and dp and dim % _axis_size(mesh, dp) == 0:
            ax = dp if len(dp) > 1 else dp[0]
        elif kind == "tp" and tp and dim % _axis_size(mesh, tp) == 0:
            ax = tp
        entries.append(ax)
    return P(*entries)


def constrain(x, kinds):
    """kinds: 'dp' | 'tp' | None per dim of x (may be shorter: the missing
    dims are unconstrained).  A DTensor under a mesh context is
    redistributed to the placements the reference's constraint gives, with
    its divisibility gates, and so is its gradient; anything else passes
    through."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import placements
    want = placements(mesh, _spec(x.shape, kinds))
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    # the gradient is laid out the same way (as XLA's constraint binds the
    # transposed value too): a partial sum arriving here is reduced, not
    # carried on to make the next matmul gather its weights
    return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _local(a, mesh, want, grad=None):
    """This rank's shard of ``a`` laid out by the placements ``want``: a
    DTensor through DTensor's redistribution, its gradient arriving laid
    out by ``grad`` (default ``want``); a plain tensor every rank holds
    whole by a slice."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        if list(a.placements) != list(want):
            a = a.redistribute(mesh, want)
        return a.to_local(grad_placements=grad)
    coord = mesh.get_coordinate()
    for md, p in enumerate(want):        # mesh order: the major split first
        if p.is_shard():
            size = a.shape[p.dim] // mesh.size(md)
            a = a.narrow(p.dim, coord[md] * size, size)
    return a


def shard_map(fn, args, kinds, out_like=0):
    """``fn`` on this rank's shards of ``args``, each laid out by its
    ``kinds`` (as ``constrain``): the reference's ``shard_map`` for a
    function that is local over the dims the kinds split (batch, heads).
    Its result (or each of a tuple of results) has the shape and layout of
    ``args[out_like]``, or of a ``(shape, kinds)`` pair (``out_like`` a
    tuple of these for a tuple of results).  Without a mesh, or with no
    DTensor among ``args``, it is ``fn(*args)``."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from .sharding import placements
    pls = [placements(mesh, _spec(a.shape, k)) for a, k in zip(args, kinds)]
    # on a mesh dim that splits the work, an argument every rank holds
    # whole gets a partial gradient from each rank
    split = [any(pl[md].is_shard() for pl in pls) for md in range(mesh.ndim)]
    grads = [[Partial() if split[md] and p.is_replicate() else p
              for md, p in enumerate(pl)] for pl in pls]
    out = fn(*(_local(a, mesh, pl, g) for a, pl, g in zip(args, pls, grads)))

    def wrap(t, like):
        if isinstance(like, int):
            shape, pl = args[like].shape, pls[like]
        else:
            shape, pl = torch.Size(like[0]), placements(mesh, _spec(*like))
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    if isinstance(out, tuple):
        return tuple(wrap(t, like) for t, like in zip(out, out_like))
    return wrap(out, out_like)


def gather_weights(tree):
    """Under a mesh, the DTensor leaves of ``tree`` replicated over the DP
    axes, their TP splits kept: ZeRO-3's gather of a layer's weights
    before it runs (the reference's activation constraints make GSPMD
    gather weights, not activations).  Anything else passes through."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(tree, DTensor):
        return tree
    names = tuple(mesh.mesh_dim_names)
    want = [Replicate() if names[md] in _CTX["dp_axes"] else p
            for md, p in enumerate(tree.placements)]
    return tree if want == list(tree.placements) else tree.redistribute(mesh, want)


def write_slots(t, pos: int, v) -> None:
    """``t[:, pos:pos + v.shape[1]] = v`` in place.  Under a mesh, with
    ``t``'s dim 1 (a cache's time) split over ranks, each rank writes the
    slots it holds and no more."""
    mesh = _CTX["mesh"]
    from torch.distributed.tensor import DTensor, Replicate
    if mesh is None or not isinstance(t, DTensor) \
            or not any(p.is_shard(1) for p in t.placements):
        t[:, pos:pos + v.shape[1]] = v
        return
    vl = _local(v, mesh, [Replicate() if p.is_shard(1) else p for p in t.placements])
    loc, lo, block = t.to_local(), 0, t.shape[1]
    for md, p in enumerate(t.placements):      # mesh order: the major split first
        if p.is_shard(1):
            block //= mesh.size(md)
            lo += mesh.get_coordinate()[md] * block
    a, b = max(pos, lo), min(pos + v.shape[1], lo + loc.shape[1])
    if a < b:
        loc[:, a - lo:b - lo] = vl[:, a - pos:b - pos]


def one_rank_group(backend: str):
    """The default process group of a world of one rank (``"nccl"`` on the
    card, ``"gloo"`` on the CPU), made in-process with no network: a
    ``HashStore`` is the rendezvous.  Reused if this process already has
    one; raises if that one differs."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = (dist.get_backend(), dist.get_world_size())
    if have != (backend, 1):
        raise RuntimeError(f"one_rank_group: the default process group is "
                           f"{have[0]} over {have[1]} ranks, not {backend} "
                           "over 1")
    return dist.group.WORLD
