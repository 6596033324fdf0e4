"""Checkpointing torch tensors through the paper's compression engine.

Every tensor in the train state is a *branch* in a BasketFile, written with
the same container bytes as the reference's ``repro.checkpoint``: the codec
policy picks algo/level/preconditioner per tensor (BitShuffle for floats,
Shuffle for integers and bf16 bit patterns, Delta+Shuffle for offset-like
integers) and every basket carries the adler32 of its raw bytes.

What moves onto the GPU is the preconditioner.  For a CUDA tensor, each
basket is preconditioned on the card by the kernels of
:mod:`repro_torch.kernels`; the preconditioned bytes and the raw bytes (for
the checksum) come down to pinned host buffers on a side stream, at most
``stage_depth`` baskets ahead, and only the codec runs on the host.  Restore
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

Not ported yet (ROADMAP.md queue A): ``producers>1`` (buffer merger),
``tuner=``/``objective=``/``tune=`` (measured codec selection),
``prefetch>0`` and ``shardings=``.
"""

from __future__ import annotations

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


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported to repro_torch yet: "
                               f"ROADMAP.md queue A, '{item}'")


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
    """Precondition each basket on the card (current stream), then bring its
    preconditioned and raw bytes down on a side stream, ``stage_depth``
    baskets ahead of the consumer.  ``host_raw`` already holds every raw
    byte (gather staging); else ``first_raw`` holds the first basket's (the
    policy probe) and the others come down one by one."""
    main = torch.cuda.current_stream(xb.device)
    side = torch.cuda.Stream(xb.device)
    pending: deque = deque()

    def start(i, span):
        s, count, lo, hi = span
        raw = xb[lo:hi]
        staged = ops.precondition(spec, raw)
        ready = torch.cuda.Event()
        ready.record(main)
        with torch.cuda.stream(side):
            side.wait_event(ready)
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
            done.record(side)
        # ``staged`` stays referenced until ``done``: its device memory must
        # outlive the side stream's copy
        return s, count, hi - lo, raw_h, staged_h, staged, done

    def finish():
        s, count, orig_len, raw_h, staged_h, _staged, done = pending.popleft()
        with obs.histogram("ckpt.stage.wait_s").time():   # kernels + D2H
            done.synchronize()
        return s, count, _mv(staged_h), orig_len, _adler(raw_h)

    for i, span in enumerate(spans):
        pending.append(start(i, span))
        if len(pending) >= max(stage_depth, 1):
            yield finish()
    while pending:
        yield finish()


def _tensor_branch(name: str, t: torch.Tensor, profile: str,
                   stage_depth: int, gather: bool):
    """(dtype_str, shape, chunk_iter, cfg) for one torch tensor.

    The policy probes the first basket's raw bytes (``gather``: the whole
    tensor's), as the reference's stream (gather) staging does."""
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
    cfg = choose(name, probe.numpy().view(np_dtype), profile)
    if xb.is_cuda:
        chunks = _gpu_chunks(xb, spans, cfg.precond, stage_depth,
                             host_raw, probe)
    else:
        chunks = _cpu_chunks(xb, spans, cfg.precond)
    return np_dtype.str, shape, chunks, cfg


def _branch(name: str, val, profile: str, stage_depth: int, gather: bool):
    if isinstance(val, torch.Tensor):
        return _tensor_branch(name, val, profile, stage_depth, gather)
    arr = _np_view(val)
    return (arr.dtype.str, arr.shape, split_array(arr, _TARGET_BASKET_BYTES),
            choose(name, arr, profile))


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
    XOR sidecar."""
    if staging not in ("stream", "gather"):
        raise ValueError(f"staging must be 'stream' or 'gather', got {staging!r}")
    if producers > 1:
        raise _not_ported("producers>1", "buffer merger in the port")
    if tuner is not None or objective is not None:
        raise _not_ported("tuner=/objective=", "tune in the port")
    flat = {n: v for n, v in _flatten_with_paths(tree).items() if v is not None}
    stats = {"branches": 0, "raw": 0, "comp": 0}
    bf16_paths = [n for n, v in flat.items()
                  if (v.dtype == torch.bfloat16 if isinstance(v, torch.Tensor)
                      else str(getattr(v, "dtype", "")) == "bfloat16")]
    meta = {"bf16": bf16_paths}
    if extra_meta:
        meta.update(extra_meta)
    meta_blob = json.dumps(meta).encode()

    t0 = time.perf_counter()
    with obs.trace.span("ckpt.save", cat="ckpt", path=path,
                        branches=len(flat)), \
            obs.profile.mem_phase("ckpt.save"), \
            BasketWriter(path, workers=workers, parity=parity) as w:
        for name in flat:
            dtype, shape, chunks, cfg = _branch(
                name, flat[name], profile, stage_depth, staging == "gather")
            with obs.trace.span("ckpt.write_branch", cat="ckpt", branch=name):
                _entry_stats(stats, w.write_branch_chunks(
                    name, dtype=dtype, shape=shape, chunks=chunks, cfg=cfg))
        w.write_blob("__meta__", meta_blob)
    obs.histogram("ckpt.save_s").observe(time.perf_counter() - t0)
    obs.counter("ckpt.saves").inc()
    return stats


# ---------------------------------------------------------------------------
# baskets -> tensor (inverse preconditioner on the destination's device)
# ---------------------------------------------------------------------------

def _read_tensor(f: BasketFile, name: str, bf16: bool, device: torch.device,
                 workers: int) -> torch.Tensor:
    """Decode one branch straight into a tensor on ``device``: the codec on
    the host, the inverse preconditioner on the device, then every basket's
    raw adler32 checked on the host."""
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

    ``heal="auto"``: a basket that fails its checksum is reconstructed from
    the ``<path>.parity`` sidecar, as in the reference."""
    if shardings is not None:
        raise _not_ported("shardings=", "parallel slice")
    device = _resolve_device(device)
    t0 = time.perf_counter()
    with obs.trace.span("ckpt.load", cat="ckpt", path=path), \
            obs.profile.mem_phase("ckpt.load"), \
            BasketFile(path, workers=workers, prefetch=prefetch,
                       heal=heal) as f:
        meta = json.loads(bytes(f.read_branch("__meta__")).decode())
        bf16 = set(meta.get("bf16", []))
        flat = {}
        for name in f.branch_names():
            if name == "__meta__":
                continue
            with obs.trace.span("ckpt.read_branch", cat="ckpt", branch=name):
                flat[name] = _read_tensor(f, name, name in bf16, device,
                                          workers)
    obs.histogram("ckpt.load_s").observe(time.perf_counter() - t0)
    obs.counter("ckpt.loads").inc()
    if template is None:
        return flat, meta
    return _rebuild(template, flat), meta


def tree_from_numpy(tree, device=None, bf16: Iterable[str] = ()):
    """The reference's state as nested numpy arrays -> the port's tensors.

    bf16 leaves arrive as their uint16 bit patterns, named by dotted path in
    ``bf16`` (the checkpoint's ``__meta__["bf16"]`` list), so no bf16 numpy
    dtype is needed.  ``device`` defaults to the GPU."""
    device = _resolve_device(device)
    bf16 = set(bf16)
    flat = {}
    for name, val in _flatten_with_paths(tree).items():
        if val is None:
            continue
        t = torch.from_numpy(np.array(val, copy=True))
        if name in bf16:
            t = t.view(torch.bfloat16)
        flat[name] = t.to(device)
    return _rebuild(tree, flat)


# ---------------------------------------------------------------------------
# manager: async saves, retention, resume
# ---------------------------------------------------------------------------

def _snapshot(tree):
    """A copy of every leaf on its own device, made on the current stream."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        return None if v is None else np.array(v, copy=True)

    flat = {n: copy(v) for n, v in _flatten_with_paths(tree).items()}
    return _rebuild(tree, flat)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 profile: str = "checkpoint", workers: int = 0,
                 producers: int = 1, tune: bool = False, objective=None,
                 parity: int = 0):
        if producers > 1:
            raise _not_ported("producers>1", "buffer merger in the port")
        if tune or objective is not None:
            raise _not_ported("tune=/objective=", "tune in the port")
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.profile = profile
        self.workers = workers        # basket-parallel compression width
        self.parity = int(parity)     # XOR parity sidecar stripe width (0 = off)
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
        if snapshot is None:
            snapshot = not wait
        src = _snapshot(tree) if snapshot else tree
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
                                    workers=self.workers, staging="stream",
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
