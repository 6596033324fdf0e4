"""Multi-pod dry run of the port: prove the parallel layout is coherent and
count what one rank does, without a GPU.

The port of ``repro/launch/dryrun.py``.  For every (architecture x input
shape) cell, on the single-pod (16, 16) mesh and the two-pod (2, 16, 16)
mesh, this process becomes rank 0 of a fake world of 256 or 512 ranks
(``torch.testing``'s fake process group: collectives return at once and
move nothing) and:

    mesh = make_production_mesh(...)               # a DeviceMesh
    cell = build_cell(cfg, shape, mesh)            # step, meta args, shardings
    with FakeTensorMode():
        args = the cell's args as DTensors on the rules' placements
        with activation_context(mesh), CostMode() as cost:
            out = cell.fn(*args)                   # the step
            out laid out on the cell's out_shardings

with ``constrain`` active.  ``CostMode`` (``launch/hlo_cost.py``) counts
the FLOPs, bytes and collectives of rank 0's local ops and the high-water
mark of its live storages.  Any failure (an op DTensor cannot lay out, a
shape the rules break) prints ``FAIL`` for the cell, as the reference's
does.  Results land as JSON in ``artifacts/dryrun_torch/`` in the
reference's schema, key for key, so ``benchmarks/roofline.py`` reads them:

  * ``lower_s`` is the time to trace the cell (at its three depths, see
    :func:`trace`), ``compile_s`` 0;
  * ``per_device.arg_bytes`` the local shards of the arguments,
    ``out_bytes`` of the outputs, ``peak_bytes`` the live storages'
    high-water mark, ``temp_bytes`` the peak less arguments and outputs
    (outputs that alias an argument counted once); ``dot_flops`` (added)
    the matmul FLOPs alone;
  * ``xla_flops_once`` is the per-device FLOPs again: the eager step has
    no loop bodies to count once;
  * ``roofline_s`` against the NVIDIA H100 SXM's published figures
    (``H100``), not measured ones: the card's own GEMM and copy rates are
    printed by ``chip_smoke.py`` phase 10.

``torch.distributed._tools.mem_tracker.MemTracker`` is not used for the
peak: on DTensors it also counts the global-shape tensors DTensor makes to
propagate metadata, many times what the rank holds.

Usage (a process of its own: a process has one default process group):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape all --mesh both [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import SHAPES, ShapeSpec, get_config, list_archs, shapes_for
from ..parallel.actctx import activation_context
from ..parallel.sharding import NamedSharding
from ..train.step import TrainState
from .hlo_cost import Cost, CostMode
from .mesh import _mesh, make_production_mesh
from .specs import (active_params, build_cell, default_accum, parallelism_for,
                    total_params)

__all__ = ["H100", "run_cell", "run_shape", "init_fake_world", "trace", "main"]

# NVIDIA H100 SXM data sheet (dense, no sparsity; at the 700 W limit)
H100 = {"flops_bf16": 989.4e12,      # bf16 tensor cores
        "hbm_bytes_per_s": 3.35e12,  # HBM3
        "link_bytes_per_s": 450e9}   # NVLink 4, one direction

PERF_KEYS = ("rms_einsum", "softmax_bf16_probs", "mamba_bf16_y", "bf16_grads",
             "compressed_tp")


def set_perf_flags(names: list[str]) -> dict:
    """Toggle the §Perf variants; returns train_kwargs additions.  The port
    has none of the layers' variants yet: a model that meets one raises
    ``NotImplementedError`` naming ROADMAP A12."""
    from ..models import layers as L, rwkv as R, ssm as S
    L.PERF_FLAGS["rms_einsum"] = "rms_einsum" in names
    L.PERF_FLAGS["softmax_bf16_probs"] = "softmax_bf16_probs" in names
    S.PERF_FLAGS["mamba_bf16_y"] = "mamba_bf16_y" in names
    R.PERF_FLAGS["compressed_tp"] = "compressed_tp" in names
    return {"bf16_grads": True} if "bf16_grads" in names else {}


def init_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake world of ``world_size`` ranks
    (replacing a fake world of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _map(fn, tree, sh):
    """``fn(leaf, sharding)`` over a tree of tensors and its sharding tree
    (a single NamedSharding covers a whole subtree)."""
    if isinstance(tree, TrainState):
        return TrainState(*(_map(fn, getattr(tree, f.name),
                                 getattr(sh, f.name) if isinstance(sh, TrainState) else sh)
                            for f in dataclasses.fields(TrainState)))
    if isinstance(tree, dict):
        return {k: _map(fn, v, sh if isinstance(sh, NamedSharding) or sh is None
                        else sh[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, sh if isinstance(sh, NamedSharding) or sh is None
                               else sh[i]) for i, v in enumerate(tree))
    return fn(tree, sh)


def _lay_out(meta, sh):
    """A meta tensor -> a fake DTensor with this rank's shard of it."""
    from torch.distributed.tensor import DTensor
    if not isinstance(meta, torch.Tensor) or sh is None:
        return meta
    local = torch.empty(sh.shard_shape(meta.shape), dtype=meta.dtype)
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _to_sharding(x, sh):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and sh is not None and list(x.placements) != sh.placements:
        return x.redistribute(sh.mesh, sh.placements)
    return x


def _leaves(tree) -> list:
    if isinstance(tree, TrainState):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def trace_cell(cell, mesh) -> dict:
    """Run ``cell``'s step once on fake DTensors over ``mesh``; rank 0's
    counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.monotonic()
    with FakeTensorMode():
        args = _map(_lay_out, cell.args, cell.in_shardings)
        cost = CostMode()
        cost.track(_local_tensors(args))
        with implicit_replication(), activation_context(mesh), cost:
            out = _map(_to_sharding, cell.fn(*args), cell.out_shardings)
        arg_t, out_t = _local_tensors(args), _local_tensors(out)
        arg_keys = {t.untyped_storage()._cdata for t in arg_t}
        alias = _bytes(t for t in out_t if t.untyped_storage()._cdata in arg_keys)
    trace_s = time.monotonic() - t0
    arg_b, out_b = _bytes(arg_t), _bytes(out_t)
    return {"trace_s": trace_s, "cost": cost.cost, "dot_flops": cost.dot_flops,
            "arg_bytes": arg_b, "out_bytes": out_b,
            "peak_bytes": cost.peak_bytes,
            "temp_bytes": max(cost.peak_bytes - arg_b - out_b + alias, 0)}


def _extend(f1, f2, f3, n: int):
    """The quadratic through (1, f1), (2, f2), (3, f3), at n; through dicts
    and Cost (a missing entry: 0)."""
    if isinstance(f1, Cost):
        return Cost(**{f.name: _extend(*(getattr(x, f.name) for x in (f1, f2, f3)), n)
                       for f in dataclasses.fields(Cost)})
    if any(isinstance(x, dict) for x in (f1, f2, f3)):
        f1, f2, f3 = f1 or {}, f2 or {}, f3 or {}
        return {k: _extend(f1.get(k), f2.get(k), f3.get(k), n)
                for k in {**f1, **f2, **f3}}
    f1, f2, f3 = f1 or 0, f2 or 0, f3 or 0
    return f1 + (n - 1) * (f2 - f1) + (n - 1) * (n - 2) // 2 * (f3 - 2 * f2 + f1)


def trace(cfg, shape: ShapeSpec, mesh, pcfg=None, train_kwargs=None) -> dict:
    """Rank 0's counts for ``cfg`` at full depth.  The groups of layers are
    identical, so the step is traced at one, two and three groups and every
    count (FLOPs, bytes, collectives, the argument, output and peak bytes)
    is extended to the full depth as a quadratic in the number of groups:
    linear for the groups' own work (the reference's walker multiplies the
    scanned group body by its trip count the same way), plus the
    backward's gradient of each group's slice of the stacked parameters,
    written into a zeroed whole stack, once a group.  The peak is a maximum
    over the step, not a sum, so its extension is an estimate: against a
    trace of four groups it holds within 5 % (``tests/test_torch_dryrun.py``).
    The train step keeps
    the full depth's microbatching and moment type."""
    kw = dict(train_kwargs or {})
    if shape.kind == "train":
        kw.setdefault("accum", default_accum(cfg, shape, mesh))
        kw.setdefault("bf16_moments", total_params(cfg) >= 200e9)
    n = cfg.n_groups
    if n <= 3:
        return trace_cell(build_cell(cfg, shape, mesh, pcfg, kw), mesh)
    t = [trace_cell(build_cell(dataclasses.replace(
        cfg, n_layers=len(cfg.pattern) * g), shape, mesh, pcfg, kw), mesh)
        for g in (1, 2, 3)]
    out = {k: _extend(t[0][k], t[1][k], t[2][k], n) for k in t[0] if k != "trace_s"}
    out["trace_s"] = sum(x["trace_s"] for x in t)
    return out


def record(arch: str, cfg, shape: ShapeSpec, mesh_tag: str, n_dev: int, t: dict) -> dict:
    """The reference's JSON record for one traced cell."""
    cost = t["cost"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = active_params(cfg)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_tag, "devices": int(n_dev),
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params_total": int(total_params(cfg)), "params_active": int(n_active),
        "lower_s": round(t["trace_s"], 2), "compile_s": 0.0,
        "per_device": {
            "hlo_flops": cost.flops, "hlo_bytes": cost.bytes,
            "collective_wire_bytes": cost.coll_wire,
            "arg_bytes": t["arg_bytes"], "out_bytes": t["out_bytes"],
            "temp_bytes": t["temp_bytes"], "peak_bytes": t["peak_bytes"],
            "dot_flops": t["dot_flops"],
        },
        "collectives": {"per_kind": cost.per_kind,
                        "total": {"count": cost.coll_count,
                                  "payload_bytes": cost.coll_payload,
                                  "wire_bytes": cost.coll_wire},
                        "unknown_trip_loops": cost.unknown_loops},
        "xla_flops_once": float(cost.flops),
        "model_flops_global": float(model_flops),
        "roofline_s": {
            "compute": cost.flops / H100["flops_bf16"],
            "memory": cost.bytes / H100["hbm_bytes_per_s"],
            "collective": cost.coll_wire / H100["link_bytes_per_s"],
        },
        "device_figures": "NVIDIA H100 SXM data sheet",
    }
    terms = rec["roofline_s"]
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["mfu_vs_roofline"] = (
        (model_flops / n_dev / H100["flops_bf16"]) / max(max(terms.values()), 1e-30))
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             pcfg_overrides: dict | None = None,
             train_kwargs: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pcfg = parallelism_for(cfg)
    if pcfg_overrides:
        pcfg = dataclasses.replace(pcfg, **pcfg_overrides)
    return record(arch, cfg, shape, "2x16x16" if multi_pod else "16x16",
                  mesh.size(), trace(cfg, shape, mesh, pcfg, train_kwargs))


def run_shape(cfg, shape: ShapeSpec, mesh_shape=(1, 1),
              train_kwargs: dict | None = None) -> dict:
    """One cell of any ``cfg`` and ``shape`` on a fake world of
    ``mesh_shape`` over ("data", "model"), or ("pod", "data", "model") for
    three dims: a trainer's own configuration, a reduced model, a small
    mesh."""
    n = 1
    for s in mesh_shape:
        n *= s
    init_fake_world(n)
    names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    mesh = _mesh("cpu", tuple(mesh_shape), names)
    return record(cfg.name, cfg, shape, "x".join(map(str, mesh_shape)), n,
                  trace(cfg, shape, mesh, train_kwargs=train_kwargs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="", help="artifact filename suffix (perf variants)")
    ap.add_argument("--accum", type=int, default=0, help="override gradient-accumulation count")
    ap.add_argument("--perf", default="",
                    help=f"comma list of perf variants: {','.join(PERF_KEYS)}")
    args = ap.parse_args(argv)

    perf_names = [n for n in args.perf.split(",") if n]
    extra_train_kwargs = set_perf_flags(perf_names)
    if args.accum:
        extra_train_kwargs["accum"] = args.accum
        if not args.tag:
            args.tag = f"__accum{args.accum}"
    if perf_names and not args.tag:
        args.tag = "__perf-" + "-".join(perf_names)

    archs = list_archs() if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for mp in meshes:            # one fake world a mesh: all its cells
        mesh_tag = "2x16x16" if mp else "16x16"
        for arch in archs:
            shapes = [s.name for s in shapes_for(get_config(arch))]
            if args.shape != "all":
                if args.shape not in shapes:
                    print(f"-- {arch} {args.shape}: not assigned (skipped)")
                    continue
                shapes = [args.shape]
            for sname in shapes:
                try:
                    rec = run_cell(arch, sname, mp,
                                   train_kwargs=extra_train_kwargs or None)
                except Exception as e:
                    failures.append((arch, sname, mesh_tag, e))
                    print(f"FAIL {arch} {sname} {mesh_tag}: {e}")
                    traceback.print_exc()
                    continue
                fn = f"{arch}__{sname}__{mesh_tag}{args.tag}.json"
                with open(os.path.join(args.out, fn), "w") as fh:
                    json.dump(rec, fh, indent=1)
                t = rec["roofline_s"]
                print(f"OK {arch:26s} {sname:12s} {mesh_tag:8s} "
                      f"trace={rec['lower_s']:6.1f}s "
                      f"peak={rec['per_device']['peak_bytes']/2**30:6.2f}GiB "
                      f"compute={t['compute']*1e3:8.2f}ms "
                      f"mem={t['memory']*1e3:8.2f}ms "
                      f"coll={t['collective']*1e3:8.2f}ms "
                      f"-> {rec['bottleneck']} "
                      f"mfu_vs_roofline={rec['mfu_vs_roofline']:.4f}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", *f[:3], repr(f[3])[:200])
        return 1
    print("\nall dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
