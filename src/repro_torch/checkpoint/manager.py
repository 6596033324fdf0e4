"""Checkpointing torch tensors through the paper's compression engine.

Every tensor in the train state is a *branch* in a BasketFile, written with
the same container bytes as the reference's ``repro.checkpoint``: the codec
policy picks algo/level/preconditioner per tensor (BitShuffle for floats,
Shuffle for integers and bf16 bit patterns, Delta+Shuffle for offset-like
integers) and every basket carries the adler32 of its raw bytes.

What moves onto the GPU is the preconditioner.  For a CUDA tensor, each
basket is preconditioned on the card by the kernels of
:mod:`repro_torch.kernels`; the preconditioned bytes and the raw bytes (for
the checksum) come down to pinned host buffers on the same stream, at most
``stage_depth`` baskets ahead, and only the codec runs on the host.  Every
producer thread stages on a stream of its own, which first waits for the
work the caller had queued when the save began.  Restore
is the mirror: the codec decodes on the host, the bytes go up, and the
inverse kernel writes straight into the destination tensor's slice; every
basket's raw checksum is verified before :func:`load_pytree` returns.  A
CPU tensor takes the same path through the kernels' plain versions; a
numpy leaf takes the host path of the reference (numpy preconditioners).

Invariants kept from the reference: atomic commit (tmp, fsync, rename, then
the manifest), resumable ``latest_step``, retention, parity sidecars and
``heal="auto"`` restores.  torch updates tensors in place, so an async
``CheckpointManager.save`` snapshots the state on its device first (see
:meth:`CheckpointManager.save`).

``producers>1`` shards the tensor list across producer threads that fill
:class:`~repro_torch.io.merger.BasketBuffer` s drained by one
:class:`~repro_torch.io.merger.BufferMerger`; ``tuner=``/``objective=``/
``tune=`` choose each branch's codec by measurement (:mod:`repro_torch.tune`)
from the same probe the static policy reads.

DTensors: a DTensor leaf is saved whole, gathered first as the reference
gathers a sharded array to the host (a collective: every rank of its mesh
calls the save with the same tree), so the container bytes do not depend
on the layout.  ``load_pytree(shardings=)`` is the elastic restore: each
branch decodes whole on the load's device, as any branch does (a mesh of
another device type raises), and each rank keeps its own shard of it as a DTensor (no collective), the
whole tensor dropped as the branch is done.  ``load_pytree(prefetch=k)``
runs the codec stage of the next ``k`` baskets, across branch boundaries,
on the BasketFile's engine threads while the current branch's inverse
preconditioners and checksums run; the inverse stays on the device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Optional

import numpy as np
import torch

from .. import obs
from ..core.basket import (BasketMeta, ChecksumError, basket_rows,
                           byte_offsets, decompress_staged, split_array)
from ..core.bfile import (_DECODE_ERRORS, BasketFile, BasketWriter,
                          CorruptBasketError, TruncatedContainerError,
                          _fsync_dir)
from ..core.checksum import adler32_hw
from ..core.policy import choose
from ..kernels import ops

_LOG = logging.getLogger("repro_torch.checkpoint")

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "tree_from_numpy"]

_TARGET_BASKET_BYTES = 1 << 20

# torch dtype -> the numpy dtype of its stored bytes (TOC strings are numpy's
# dtype.str); bf16 is stored as its uint16 bit pattern, as the reference does
_NP_DTYPE = {
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.bfloat16: np.uint16,
    torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.uint8: np.uint8, torch.uint16: np.uint16,
    torch.uint32: np.uint32, torch.uint64: np.uint64, torch.bool: np.bool_,
}
_TORCH_DTYPE = {np.dtype(v).str: k for k, v in _NP_DTYPE.items()
                if k is not torch.bfloat16}


def _flatten_with_paths(tree) -> dict[str, Any]:
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{prefix}{k}.")
        elif node is None:
            flat[prefix.rstrip(".") + "#none"] = None
        else:
            flat[prefix.rstrip(".")] = node

    rec(tree, "")
    return flat


def _rebuild(template, flat: dict):
    """``template``'s nested-dict structure with leaves from ``flat``."""
    flat_t = _flatten_with_paths(template)

    def rec(node, prefix):
        if isinstance(node, dict):
            return {k: rec(node[k], f"{prefix}{k}.") for k in sorted(node)}
        key = prefix.rstrip(".")
        if node is None or key + "#none" in flat_t:
            return None
        return flat[key]

    return rec(template, "")


def _resolve_device(device) -> torch.device:
    """Entry points default to the card and never land on the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to load onto the CPU")
    return dev


def _np_view(x) -> np.ndarray:
    """A host leaf (numpy array or scalar) as the array the container stores."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":        # store as raw uint16 bit pattern
        arr = arr.view(np.uint16)
    return arr


def _mv(t: torch.Tensor) -> memoryview:
    """Zero-copy buffer over a CPU uint8 tensor."""
    return memoryview(t.numpy())


def _entry_stats(stats: dict, entry: dict) -> None:
    stats["branches"] += 1
    stats["raw"] += sum(b["meta"]["orig_len"] for b in entry["baskets"])
    stats["comp"] += sum(b["meta"]["comp_len"] for b in entry["baskets"])


# ---------------------------------------------------------------------------
# tensor -> baskets (preconditioned on the tensor's device)
# ---------------------------------------------------------------------------

def _basket_spans(shape: tuple, itemsize: int) -> list[tuple[int, int, int, int]]:
    """(entry_start, entry_count, byte_lo, byte_hi) of every basket:
    exactly :func:`split_array`'s boundaries (``basket_rows``), so the
    container bytes equal the reference's."""
    n = shape[0] if shape else 1
    row_bytes = itemsize * int(np.prod(shape[1:], dtype=np.int64)) if shape \
        else itemsize
    rows_per = basket_rows(shape, itemsize, _TARGET_BASKET_BYTES)
    spans = [(s, min(s + rows_per, n) - s, s * row_bytes,
              min(s + rows_per, n) * row_bytes) for s in range(0, n, rows_per)]
    return spans or [(0, 0, 0, 0)]          # an empty tensor is one empty basket


def _whole(v):
    """A DTensor gathered whole on every rank of its mesh; other leaves as
    they are."""
    from torch.distributed.tensor import DTensor
    return v.full_tensor() if isinstance(v, DTensor) else v


def _host_copy(dev: torch.Tensor) -> torch.Tensor:
    """Blocking copy of device bytes into a pinned host tensor."""
    host = torch.empty(dev.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(dev)
    return host


def _adler(raw: torch.Tensor) -> int:
    with obs.histogram("ckpt.stage.adler_s").time():
        return adler32_hw(_mv(raw))


def _cpu_chunks(xb: torch.Tensor, spans, spec: str):
    for start, count, lo, hi in spans:
        raw = xb[lo:hi]
        staged = ops.precondition(spec, raw)
        yield start, count, _mv(staged), hi - lo, _adler(raw)


def _gpu_chunks(xb: torch.Tensor, spans, spec: str, stage_depth: int,
                host_raw: Optional[torch.Tensor], first_raw: torch.Tensor):
    """Precondition each basket on the card, then bring its preconditioned
    and raw bytes down, kernels and copies on the current stream,
    ``stage_depth`` baskets ahead of the consumer.  ``host_raw`` already
    holds every raw byte (gather staging); else ``first_raw`` holds the
    first basket's (the policy probe) and the others come down one by one."""
    pending: deque = deque()

    def start(i, span):
        s, count, lo, hi = span
        raw = xb[lo:hi]
        staged = ops.precondition(spec, raw)
        if host_raw is not None:
            raw_h = host_raw[lo:hi]
        elif i == 0:
            raw_h = first_raw
        else:
            raw_h = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=True)
            raw_h.copy_(raw, non_blocking=True)
        if staged is raw:
            staged_h = raw_h
        else:
            staged_h = torch.empty(staged.numel(), dtype=torch.uint8,
                                   pin_memory=True)
            staged_h.copy_(staged, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return s, count, hi - lo, raw_h, staged_h, done

    def finish():
        s, count, orig_len, raw_h, staged_h, done = pending.popleft()
        with obs.histogram("ckpt.stage.wait_s").time():   # kernels + D2H
            done.synchronize()
        return s, count, _mv(staged_h), orig_len, _adler(raw_h)

    for i, span in enumerate(spans):
        pending.append(start(i, span))
        if len(pending) >= max(stage_depth, 1):
            yield finish()
    while pending:
        yield finish()


def _branch_cfg(name: str, probe: np.ndarray, profile: str, tuner):
    """Static policy or measured tuner decision for one branch probe."""
    if tuner is not None:
        return tuner.config_for(name, probe)
    return choose(name, probe, profile)


def _tensor_branch(name: str, t: torch.Tensor, profile: str,
                   stage_depth: int, gather: bool, tuner=None):
    """(dtype_str, shape, chunk_iter, cfg) for one torch tensor.

    The policy (or the tuner) probes the first basket's raw bytes
    (``gather``: the whole tensor's), as the reference's stream (gather)
    staging does; bf16 reads as its uint16 bit pattern."""
    if t.dtype not in _NP_DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype} has no container dtype")
    np_dtype = np.dtype(_NP_DTYPE[t.dtype])
    shape = tuple(t.shape)
    xb = t.detach().contiguous().reshape(-1).view(torch.uint8)
    spans = _basket_spans(shape, np_dtype.itemsize)
    _, _, lo, hi = spans[0]
    if xb.is_cuda:
        host_raw = _host_copy(xb) if gather else None
        probe = host_raw if gather else _host_copy(xb[lo:hi])
    else:
        probe = xb if gather else xb[lo:hi]
    cfg = _branch_cfg(name, probe.numpy().view(np_dtype), profile, tuner)
    if xb.is_cuda:
        chunks = _gpu_chunks(xb, spans, cfg.precond, stage_depth,
                             host_raw, probe)
    else:
        chunks = _cpu_chunks(xb, spans, cfg.precond)
    return np_dtype.str, shape, chunks, cfg


def _branch(name: str, val, profile: str, stage_depth: int, gather: bool,
            tuner=None):
    if isinstance(val, torch.Tensor):
        return _tensor_branch(name, val, profile, stage_depth, gather, tuner)
    arr = _np_view(val)
    return (arr.dtype.str, arr.shape, split_array(arr, _TARGET_BASKET_BYTES),
            _branch_cfg(name, arr, profile, tuner))


def _queued_work(flat: dict) -> dict:
    """{device: event} marking, on each CUDA device the tree's tensors live
    on, the work queued on the caller's current stream."""
    ready = {}
    for v in flat.values():
        if isinstance(v, torch.Tensor) and v.is_cuda and v.device not in ready:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            ready[v.device] = ev
    return ready


@contextlib.contextmanager
def _own_streams(ready: dict):
    """A new stream current on every device of ``ready``, each behind the
    work its event marks: one producer's kernels and copies stay on one
    stream, apart from the caller's and the other producers'."""
    with contextlib.ExitStack() as stack:
        for dev, ev in ready.items():
            stream = torch.cuda.Stream(dev)
            stream.wait_event(ev)
            stack.enter_context(torch.cuda.stream(stream))
        yield


def save_pytree(path: str, tree, profile: str = "checkpoint",
                extra_meta: Optional[dict] = None,
                workers: int = 0, producers: int = 1,
                staging: str = "stream", stage_depth: int = 2,
                tuner=None, objective=None, parity: int = 0) -> dict:
    """Write a nested dict of torch tensors (or numpy arrays) as one
    BasketFile, byte-identical to the reference's ``save_pytree`` of the
    same values.

    Each tensor follows its device: a CUDA tensor is preconditioned by the
    CUDA kernels, a CPU tensor by their plain versions; a numpy leaf takes
    the reference's host path.  ``staging="stream"`` probes the codec
    policy on each tensor's first basket and keeps ``stage_depth`` baskets
    in flight; ``"gather"`` copies the whole tensor down first and probes
    all of it.  Both give the reference's basket boundaries.  ``workers>0``
    compresses baskets in parallel (same bytes); ``parity=k`` writes the
    XOR sidecar.

    ``producers>1`` shards the tensor list across producer threads, each
    compressing its branches into an in-memory BasketBuffer that one
    BufferMerger drains into the file without recompression.  The branch
    order, hence the container's bytes, then depends on thread timing; the
    contents round-trip the same (restore is keyed by name).

    ``objective=`` (or an explicit ``tuner=``) chooses each branch's codec
    from trial compressions of the probe (:mod:`repro_torch.tune`) in
    place of the static ``profile``; the decisions persist in the file's
    TOC.  A tuned decision preconditions on the tensor's device exactly as
    a static spec does (``zigzag{N}`` included)."""
    if staging not in ("stream", "gather"):
        raise ValueError(f"staging must be 'stream' or 'gather', got {staging!r}")
    if tuner is None and objective is not None:
        from ..tune import Tuner
        tuner = Tuner(objective, fallback_profile=profile)
    flat = {n: _whole(v) for n, v in _flatten_with_paths(tree).items()
            if v is not None}
    stats = {"branches": 0, "raw": 0, "comp": 0}
    bf16_paths = [n for n, v in flat.items()
                  if (v.dtype == torch.bfloat16 if isinstance(v, torch.Tensor)
                      else str(getattr(v, "dtype", "")) == "bfloat16")]
    meta = {"bf16": bf16_paths}
    if extra_meta:
        meta.update(extra_meta)
    meta_blob = json.dumps(meta).encode()
    ready = _queued_work(flat)

    def write(sink, name):
        dtype, shape, chunks, cfg = _branch(
            name, flat[name], profile, stage_depth, staging == "gather", tuner)
        with obs.trace.span("ckpt.write_branch", cat="ckpt", branch=name):
            return sink.write_branch_chunks(name, dtype=dtype, shape=shape,
                                            chunks=chunks, cfg=cfg)

    def lend_engine(engine):
        # trial matrices fan out through the write's own engine; a
        # manager-held tuner must not keep an engine that closes with
        # this save
        if tuner is not None and tuner.engine is None and engine is not None:
            tuner.engine = engine
            return lambda: setattr(tuner, "engine", None)
        return lambda: None

    t0 = time.perf_counter()
    if producers <= 1:
        with obs.trace.span("ckpt.save", cat="ckpt", path=path,
                            branches=len(flat)), \
                obs.profile.mem_phase("ckpt.save"), \
                BasketWriter(path, workers=workers, tuner=tuner,
                             parity=parity) as w:
            unlend = lend_engine(w._engine)
            try:
                with _own_streams(ready):
                    for name in flat:
                        _entry_stats(stats, write(w, name))
                w.write_blob("__meta__", meta_blob)
            finally:
                unlend()
        obs.histogram("ckpt.save_s").observe(time.perf_counter() - t0)
        obs.counter("ckpt.saves").inc()
        return stats

    from ..io.merger import BufferMerger
    names = list(flat)
    shards = [names[i::producers] for i in range(producers)]
    errors: list = []
    lock = threading.Lock()
    with obs.trace.span("ckpt.save", cat="ckpt", path=path,
                        branches=len(flat)), \
            obs.profile.mem_phase("ckpt.save"), \
            BufferMerger(path, workers=workers, tuner=tuner,
                         parity=parity) as m:
        unlend = lend_engine(m._engine)

        def produce(shard):
            try:
                with _own_streams(ready):
                    for name in shard:
                        buf = m.buffer()
                        entry = write(buf, name)
                        m.merge(buf)
                        with lock:
                            _entry_stats(stats, entry)
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=produce, args=(s,), daemon=True,
                                    name=f"ckpt-producer-{i}")
                   for i, s in enumerate(shards) if s]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            unlend()
        if errors:
            raise errors[0]
        buf = m.buffer()
        buf.write_blob("__meta__", meta_blob)
        m.merge(buf)
    obs.histogram("ckpt.save_s").observe(time.perf_counter() - t0)
    obs.counter("ckpt.saves").inc()
    return stats


# ---------------------------------------------------------------------------
# baskets -> tensor (inverse preconditioner on the destination's device)
# ---------------------------------------------------------------------------

class _StagedAhead:
    """The codec stage of the restore, run ahead on the BasketFile's
    engine threads (``load_pytree(prefetch=k)``): asking for basket ``i`` of
    a branch schedules every basket up to ``k`` past it in restore order,
    across branch boundaries, so the next branch decompresses while this
    one's inverse preconditioners and checksums run.  A future holds the
    preconditioned bytes, or the decode error for the caller to heal."""

    def __init__(self, f: BasketFile, names: list[str], ahead: int):
        self._f = f
        self._order = [(n, i) for n in names
                       for i in range(len(f.branches[n]["baskets"]))]
        self._pos = {key: p for p, key in enumerate(self._order)}
        self._ahead = ahead
        self._next = 0
        self._futs: dict[tuple[str, int], Any] = {}
        self._lock = threading.Lock()

    def _stage(self, name: str, i: int):
        entry = self._f.branches[name]
        meta = BasketMeta.from_json(entry["baskets"][i]["meta"])
        with obs.histogram("ckpt.restore.codec_s").time():
            return decompress_staged(self._f.read_basket_payload(name, i),
                                     meta, self._f._dictionary(entry))

    def take(self, name: str, i: int):
        """The preconditioned bytes of basket ``i`` (raises its decode
        error); each basket is taken once."""
        with self._lock:
            stop = min(self._pos[(name, i)] + self._ahead + 1, len(self._order))
            while self._next < stop:
                key = self._order[self._next]
                self._futs[key] = self._f._engine.submit(self._stage, *key)
                self._next += 1
            fut = self._futs.pop((name, i))
        return fut.result()


def _read_tensor(f: BasketFile, name: str, bf16: bool, device: torch.device,
                 workers: int, ahead: Optional[_StagedAhead] = None
                 ) -> torch.Tensor:
    """Decode one branch straight into a tensor on ``device``: the codec on
    the host (from ``ahead`` when the restore prefetches), the inverse
    preconditioner on the device, then every basket's raw adler32 checked
    on the host."""
    entry = f.branches[name]
    dtype = torch.bfloat16 if bf16 else _TORCH_DTYPE[np.dtype(entry["dtype"]).str]
    out = torch.empty(tuple(entry["shape"]), dtype=dtype, device=device)
    flat = out.reshape(-1).view(torch.uint8)
    baskets = entry["baskets"]
    metas = [BasketMeta.from_json(b["meta"]) for b in baskets]
    offs, total = byte_offsets(m.orig_len for m in metas)
    if total != flat.numel():
        raise ValueError(f"{f.path}: branch {name!r} baskets hold {total} "
                         f"bytes, its shape needs {flat.numel()}")
    dictionary = f._dictionary(entry)
    cuda = device.type == "cuda"
    stream = torch.cuda.current_stream(device) if cuda else None

    def dest(i: int) -> torch.Tensor:
        return flat[offs[i]:offs[i] + metas[i].orig_len]

    def healed(i: int, cause) -> None:
        """Repair basket ``i`` from the parity sidecar (``heal="auto"``) or
        raise the reference's error for it."""
        if f.heal != "auto":
            if isinstance(cause, ChecksumError):
                raise f._quarantine(name, i, baskets[i], cause) from cause
            raise cause
        raw = f._heal_basket(name, i, cause=cause)
        with torch.cuda.stream(stream):
            dest(i).copy_(torch.from_numpy(np.frombuffer(raw, np.uint8).copy()))

    def decode(i: int) -> None:
        meta = metas[i]
        try:
            if ahead is not None:
                staged = ahead.take(name, i)
            else:
                with obs.histogram("ckpt.restore.codec_s").time():
                    staged = decompress_staged(f.read_basket_payload(name, i),
                                               meta, dictionary)
        except _DECODE_ERRORS as e:
            healed(i, e)
            return
        host = torch.empty(meta.stored_len, dtype=torch.uint8, pin_memory=cuda)
        host.numpy()[:] = np.frombuffer(staged, dtype=np.uint8)
        if not cuda:
            ops.unprecondition_into(meta.precond, host, dest(i), meta.orig_len)
            return
        with torch.cuda.stream(stream):
            ops.unprecondition_into(meta.precond,
                                    host.to(device, non_blocking=True),
                                    dest(i), meta.orig_len)

    def verify(raw: torch.Tensor, i: int) -> None:
        got = adler32_hw(_mv(raw[offs[i]:offs[i] + metas[i].orig_len]))
        if got != metas[i].checksum:
            healed(i, ChecksumError("basket checksum mismatch (corrupt data)"))

    idx = range(len(baskets))
    with ThreadPoolExecutor(max(workers, 1)) as ex:
        with obs.histogram("ckpt.restore.decode_s").time():   # wall, all threads
            list(ex.map(decode, idx))
        with obs.histogram("ckpt.restore.verify_s").time():
            # the raw bytes as the device holds them, for the adler32 check
            raw = _host_copy(flat) if cuda else flat
            list(ex.map(lambda i: verify(raw, i), idx))
    return out


def load_pytree(path: str, template=None, shardings=None, workers: int = 4,
                prefetch: int = 0, heal: Optional[str] = None, device=None):
    """Read a BasketFile back into torch tensors on ``device`` (default: the
    GPU; raises when there is none).  Returns ``(tree, meta)``; without
    ``template`` the tree is a flat ``{dotted.path: tensor}`` dict.

    ``shardings``: a matching tree of
    :class:`~repro_torch.parallel.sharding.NamedSharding` (the elastic
    re-shard): each mesh must be on ``device``'s type (raises otherwise);
    a branch with a sharding decodes on ``device`` as any branch does (the
    CUDA kernels for a CUDA device) and becomes a DTensor holding this
    rank's shard; the whole tensor is dropped before the next branch
    decodes.

    ``prefetch=k``: the codec stage of the next ``k`` baskets runs ahead on
    the BasketFile's engine threads (:class:`_StagedAhead`); the tensors are
    those of ``prefetch=0``, bit for bit.

    ``heal="auto"``: a basket that fails its checksum is reconstructed from
    the ``<path>.parity`` sidecar, as in the reference."""
    device = _resolve_device(device)
    flat_s = _flatten_with_paths(shardings) if shardings is not None else {}
    for name, sh in flat_s.items():
        if sh is not None and sh.mesh.device_type != device.type:
            raise ValueError(f"load_pytree: {name}'s sharding is on a "
                             f"{sh.mesh.device_type} mesh, not on {device}")
    if shardings is not None:
        from ..parallel.sharding import shard_tensor
    t0 = time.perf_counter()
    with obs.trace.span("ckpt.load", cat="ckpt", path=path), \
            obs.profile.mem_phase("ckpt.load"), \
            BasketFile(path, workers=workers, prefetch=prefetch,
                       heal=heal) as f:
        meta = json.loads(bytes(f.read_branch("__meta__")).decode())
        bf16 = set(meta.get("bf16", []))
        names = [n for n in f.branch_names() if n != "__meta__"]
        # the meta read made the engine the prefetching reader schedules on
        ahead = _StagedAhead(f, names, prefetch) if prefetch else None
        flat = {}
        for name in names:
            sh = flat_s.get(name)
            with obs.trace.span("ckpt.read_branch", cat="ckpt", branch=name):
                t = _read_tensor(f, name, name in bf16, device, workers, ahead)
                flat[name] = t if sh is None else shard_tensor(t, sh)
                del t
    obs.histogram("ckpt.load_s").observe(time.perf_counter() - t0)
    obs.counter("ckpt.loads").inc()
    if template is None:
        return flat, meta
    return _rebuild(template, flat), meta


def tree_from_numpy(tree, device=None, bf16: Iterable[str] = ()):
    """The reference's state as nested numpy arrays -> the port's tensors.

    A bf16 leaf arrives either as a numpy ``bfloat16`` array (``np.asarray``
    of a JAX array) or as its uint16 bit pattern named by dotted path in
    ``bf16`` (the checkpoint's ``__meta__["bf16"]`` list); both carry the
    same bits across.  ``device`` defaults to the GPU."""
    device = _resolve_device(device)
    bf16 = set(bf16)
    flat = {}
    for name, val in _flatten_with_paths(tree).items():
        if val is None:
            continue
        arr = np.array(val, copy=True)
        t = torch.from_numpy(_np_view(arr))
        if name in bf16 or arr.dtype.name == "bfloat16":
            t = t.view(torch.bfloat16)
        flat[name] = t.to(device)
    return _rebuild(tree, flat)


# ---------------------------------------------------------------------------
# manager: async saves, retention, resume
# ---------------------------------------------------------------------------

def _snapshot(tree):
    """A copy of every leaf on its own device, made on the current stream
    (a DTensor's whole, gathered)."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return _whole(v.detach()).clone()
        return None if v is None else np.array(v, copy=True)

    flat = {n: copy(v) for n, v in _flatten_with_paths(tree).items()}
    return _rebuild(tree, flat)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 profile: str = "checkpoint", workers: int = 0,
                 producers: int = 1, tune: bool = False, objective=None,
                 parity: int = 0):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.profile = profile
        self.workers = workers        # basket-parallel compression width
        self.producers = producers    # tensor-parallel producer threads (merger)
        self.parity = int(parity)     # XOR parity sidecar stripe width (0 = off)
        # measured codec selection: one tuner lives as long as the manager,
        # so step N+1 reuses step N's decisions and the drift detector
        # spans steps
        self._tuner = None
        if tune or objective is not None:
            from ..tune import OBJECTIVES, Tuner
            obj = objective if objective is not None else (
                profile if profile in OBJECTIVES else "checkpoint")
            self._tuner = Tuner(obj, fallback_profile=profile)
        self._worker: Optional[threading.Thread] = None
        self._last_stats: Optional[dict] = None
        self._error: Optional[BaseException] = None

    # -- paths -----------------------------------------------------------

    def _data_path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt-{step:08d}.bskt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.dir, f"MANIFEST-{step:08d}.json")

    # -- save ------------------------------------------------------------

    def save(self, step: int, tree, extra_meta: Optional[dict] = None,
             wait: bool = False, snapshot: Optional[bool] = None) -> None:
        """Compress + write in the background; training continues.

        torch optimizers update tensors in place, so a save that returns
        before it has read the state (``wait=False``) first copies every
        tensor on its own device (``snapshot``, default ``not wait``).  The
        copy costs one more state's worth of device memory until the
        background save ends; pass ``snapshot=False`` only when nothing
        writes the tensors before :meth:`wait`.  The background thread's
        stream waits for the work already queued on the caller's stream, so
        it reads the state (or its copy) as of this call."""
        self.wait()                                   # one in flight at a time
        if self._tuner is not None and not self._tuner.decisions:
            # re-open: seed the tuner from the latest checkpoint's header so
            # a resumed run does not re-measure what an earlier run decided
            last = self.latest_step()
            if last is not None:
                from ..tune import load_decisions
                try:
                    self._tuner.load(load_decisions(self._data_path(last)))
                except Exception:
                    pass            # unreadable or malformed header: re-tune
        if snapshot is None:
            snapshot = not wait
        # DTensors are gathered here, on the caller's thread: the gather is
        # a collective, and the save thread runs none
        src = _snapshot(tree) if snapshot else _rebuild(tree, {
            n: _whole(v) for n, v in _flatten_with_paths(tree).items()})
        ready = {}
        for v in _flatten_with_paths(src).values():
            if isinstance(v, torch.Tensor) and v.is_cuda \
                    and v.device not in ready:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(v.device))
                ready[v.device] = ev

        def work():
            try:
                for dev, ev in ready.items():
                    torch.cuda.current_stream(dev).wait_event(ev)
                t0 = time.monotonic()
                stats = save_pytree(self._data_path(step), src,
                                    self.profile, extra_meta,
                                    workers=self.workers,
                                    producers=self.producers,
                                    staging="stream", tuner=self._tuner,
                                    parity=self.parity)
                manifest = {"step": step, "time": time.time(),
                            "wall_s": time.monotonic() - t0, **stats}
                # atomic commit: tmp + fsync + rename + fsync dir — the
                # manifest is the "this step exists" marker
                tmp = self._manifest_path(step) + ".tmp"
                try:
                    with open(tmp, "w") as fh:
                        json.dump(manifest, fh)
                        fh.flush()
                        os.fsync(fh.fileno())
                    os.replace(tmp, self._manifest_path(step))
                except BaseException:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    raise
                _fsync_dir(self.dir)
                self._last_stats = manifest
                self._gc()
            except BaseException as e:   # surfaced by the next save()/wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()
        if wait:
            self.wait()

    def wait(self) -> Optional[dict]:
        """Join any in-flight save; re-raises a background-save failure."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err
        return self._last_stats

    # -- restore ---------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("MANIFEST-") and fn.endswith(".json"):
                step = int(fn[len("MANIFEST-"):-len(".json")])
                if os.path.exists(self._data_path(step)):
                    out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        st = self.steps()
        return st[-1] if st else None

    def restore(self, step: Optional[int] = None, template=None,
                shardings=None, device=None):
        """Load a step (default latest) onto ``device`` (default: the GPU).
        Returns (tree, meta).

        Every load opens with ``heal="auto"``.  With ``step=None`` a
        checkpoint that is torn or corrupt beyond healing is skipped and
        the previous known-good step loads instead; an explicit ``step=``
        means "this step or nothing"."""
        if step is not None:
            return load_pytree(self._data_path(step), template, shardings,
                               heal="auto", device=device)
        candidates = sorted(self.steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        skipped: list[tuple[int, str]] = []
        for s in candidates:
            try:
                return load_pytree(self._data_path(s), template, shardings,
                                   heal="auto", device=device)
            except (CorruptBasketError, TruncatedContainerError) as e:
                _LOG.warning("checkpoint step %d unloadable (%s); "
                             "falling back to previous step", s, e)
                obs.counter("repair.ckpt.skipped").inc()
                skipped.append((s, str(e)))
        raise ChecksumError(
            "every checkpoint in %s is corrupt beyond healing; skipped %s"
            % (self.dir, "; ".join(f"step {s}: {m}" for s, m in skipped)))

    # -- retention -------------------------------------------------------

    def _gc(self):
        from ..io import fdcache
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            for p in (self._data_path(s), self._manifest_path(s),
                      self._data_path(s) + ".parity",
                      self._data_path(s) + ".scrub"):
                fdcache.invalidate(p)   # a cached fd would pin the inode
                try:
                    os.remove(p)
                except OSError:
                    pass
