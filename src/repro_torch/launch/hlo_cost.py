"""Per-rank cost of a step, counted over the aten ops one rank runs.

The port of ``repro/launch/hlo_cost.py``, which walks XLA's optimized SPMD
module.  torch has no HLO: the step runs eagerly, so the walk here is a
``TorchDispatchMode`` (:class:`CostMode`) over the ops of one rank as the
step runs them (in the dry run, on fake tensors of a fake process group).
The reference's ``Cost`` stays the contract:

  * FLOPs: 2 * M * N * K for mm, bmm, addmm and baddbmm (K the contracted
    size), 2 per output element for a convolution, 1 per output element
    for every other op that moves bytes, as the reference's walker counts
    them (``_comp_cost``);
  * bytes: each op's operands plus its result, the eager port's real
    traffic (nothing is fused); views and the ops that move nothing
    (``_NO_TRAFFIC``, the reference's list) are skipped;
  * collectives per kind, with the reference's ring factors: an all-gather
    or an all-to-all moves (k-1)/k of its result over the wire, an
    all-reduce 2(k-1)/k, a reduce-scatter k-1 times its (scattered)
    result;
  * there are no loops to multiply, so ``unknown_loops`` is 0.

Counting the local op.  A dispatch mode sees a DTensor op first, with the
global shapes, before DTensor runs it on the local shards; DTensor then
runs the op once more on fake global-shape tensors to learn the output's
metadata.  The mode counts neither: it lets DTensor dispatch the op with
the mode still active, and counts only the ops whose tensor arguments it
has seen before (the local shards it was given, and every output it has
counted since), plus factory ops outside a DTensor op.  Each rank's
redistributions are ops on its local shards, so they count too.

Where DTensor has no rule for an op on the layout it is given (a view
that would split a sharded dim unevenly, a redistribution it cannot make),
the op raises as it would on a real mesh, and the cell fails.
``CostMode.peak_bytes`` is the high-water mark of the storages of the
tensors it has seen, sampled after every counted op.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Cost", "CostMode"]

_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
# the reference's _NO_TRAFFIC, in aten's names: allocations without a
# write, aliases, metadata and waits
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "device", "wait_tensor", "_local_scalar_dense"}
_COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("broadcast", "broadcast"))


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0
    coll_payload: float = 0.0
    coll_count: float = 0.0
    per_kind: dict = field(default_factory=dict)
    unknown_loops: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(args, kwargs) -> list:
    """An op's arguments, its tensor lists opened (one level: aten's)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def _tensors(args, kwargs=None) -> list:
    return [a for a in _flat(args, kwargs or {}) if isinstance(a, torch.Tensor)]


def _collective_kind(name: str):
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


def _group_size(func, args, kwargs) -> int:
    """k of a functional collective (its ``group_size``, or the group its
    ``group_name`` names) or of a c10d op (its ProcessGroup)."""
    schema = func._schema.arguments
    vals = dict(zip((a.name for a in schema), args))
    vals.update(kwargs)
    if isinstance(vals.get("group_size"), int):
        return vals["group_size"]
    if isinstance(vals.get("group_name"), str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(vals["group_name"]).size()
    for v in list(args) + list(kwargs.values()):
        if hasattr(v, "size") and not isinstance(v, torch.Tensor):
            try:
                return int(v.size())
            except Exception:
                continue
    return 1


def _matmul_flops(name: str, args, out) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    return 2.0 * out.numel() * a.shape[-1] if b.dim() >= 2 else 0.0


class CostMode(TorchDispatchMode):
    """Counts the cost of the local ops one rank runs (see the module's
    docstring).  ``track(tensors)`` registers the tensors (or DTensors'
    local shards) the step starts from: their bytes count toward the peak,
    and ops on them count."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.dot_flops = 0.0          # the matmuls' share of cost.flops
        self.dot_flops_by_op: dict = {}   # ... by op: mm, bmm, addmm, ...
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known: dict = {}        # id(tensor) -> weakref
        self._storages: dict = {}     # storage key -> (StorageWeakRef, nbytes, refs)
        self._pending: list = []      # storage keys whose tensor died
        self._zombies: set = set()    # storage keys held by no tracked tensor
        self._depth = 0               # nesting of DTensor ops
        self._defer = False           # the next DTensor op goes to DTensor

    # -- what has been seen, and the storages behind it -------------------

    def _see(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        i = id(t)
        if i in self._known:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages and not self._storages[key][0].expired():
            ref, n, refs = self._storages[key]
            self._storages[key] = (ref, n, refs + 1)
        else:                   # new, or a freed storage's address reused
            if key in self._storages:
                self.live_bytes -= self._storages[key][1]
            self._storages[key] = (StorageWeakRef(st), st.nbytes(), 1)
            self.live_bytes += st.nbytes()

        def gone(_, i=i, key=key):
            self._known.pop(i, None)
            self._pending.append(key)

        self._known[i] = weakref.ref(t, gone)

    def _sweep(self) -> None:
        """Drop the bytes of storages no tensor holds any more.  A storage
        whose tracked tensors have all died but which something else still
        holds (autograd's saved tensors) is checked again next time."""
        dead, self._pending = self._pending, []
        for key in dead:
            if key in self._storages:
                ref, n, refs = self._storages[key]
                self._storages[key] = (ref, n, refs - 1)
        zombies = []
        for key in set(dead) | self._zombies:
            ent = self._storages.get(key)
            if ent is None or ent[2] > 0:
                continue
            if ent[0].expired():
                del self._storages[key]
                self.live_bytes -= ent[1]
            else:
                zombies.append(key)
        self._zombies = set(zombies)

    def track(self, tensors) -> None:
        from torch.distributed.tensor import DTensor
        for t in _tensors(tensors):
            self._see(t._local_tensor if isinstance(t, DTensor) else t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- counting ---------------------------------------------------------

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        ins = _tensors(args, kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        kind = _collective_kind(name) if func.namespace in (
            "_c10d_functional", "c10d_functional", "c10d") else None
        if kind is not None:
            # an in-place c10d op writes its first tensor argument
            res = outs[0] if outs else ins[0]
            size = _nbytes(res)
            k = _group_size(func, args, kwargs)
            if k > 1:
                wire = {"all-gather": size * (k - 1) / k,
                        "all-reduce": 2.0 * size * (k - 1) / k,
                        "reduce-scatter": float(size) * (k - 1),
                        "all-to-all": size * (k - 1) / k}.get(kind, float(size))
                c = self.cost
                c.coll_wire += wire
                c.coll_payload += size
                c.coll_count += 1
                e = c.per_kind.setdefault(kind, {"count": 0.0, "payload_bytes": 0.0,
                                                 "wire_bytes": 0.0})
                e["count"] += 1
                e["payload_bytes"] += size
                e["wire_bytes"] += wire
                self.cost.bytes += size + sum(_nbytes(t) for t in ins)
            return
        if func.is_view or name in _NO_TRAFFIC or not outs:
            return
        if name in _MATMULS:
            f = _matmul_flops(name, args, outs[0])
            self.dot_flops += f
            self.dot_flops_by_op[name] = self.dot_flops_by_op.get(name, 0.0) + f
            self.cost.flops += f
        elif name == "convolution":
            self.cost.flops += 2.0 * outs[0].numel()
        else:
            self.cost.flops += sum(t.numel() for t in outs)
        self.cost.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = _flat(args, kwargs)
        if any(isinstance(a, DTensor) for a in flat):
            if self._defer:
                self._defer = False
                return NotImplemented
            self.track([a for a in flat if isinstance(a, DTensor)])
            self._depth += 1
            self._defer = True
            try:
                with self:
                    return func(*args, **kwargs)
            finally:
                self._defer = False
                self._depth -= 1
        out = func(*args, **kwargs)
        ins = _tensors(args, kwargs)
        if ins and not any(id(t) in self._known for t in ins):
            return out          # DTensor's global-shape metadata run
        if not ins and self._depth:
            return out          # ... and its fake arguments
        self._count(func, args, kwargs, out)
        self._sweep()
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out
