#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's checkpoint, training and serving paths on
one GPU and check them.

Run from the repository root:  python3 chip_smoke.py

It builds the port's kernels from ``src/repro_torch/kernels/csrc``, then
runs, failing on the first error:

1. every kernel against its plain PyTorch version on the card: the eight
   preconditioners byte-equal over itemsizes 1/2/4/8 and ragged sizes up to
   a 100 MB basket, and qpack/qunpack bit-equal over R x C shapes, types,
   zero rows, .5 ties, non-finite rows, the serve path's shapes, k = 1 and 3
   and payloads that are not 16-byte aligned, with times beside the
   memory-bandwidth bound and one-call PyTorch yardsticks (qunpack against ``torch.mul(q, s)`` at
   (32768, 2048), the prefill's (256, 2048) and the decode's (4, 2048));
   qpack at the edges of its launch (C at a block's 32, 128 and 256 threads
   and at 16 chunks +-1, C % 16 = 1 ... 15, inputs 4 and 8 bytes off a
   16-byte boundary) and timed at (32768, 2048) in f32 and bf16;
   then the forward delta, zigzag and unzigzag (one vector path) at the
   lengths it turns on (0, 1, 15, 16, 17, 256 and 269 313 vectors plus or
   minus an element, every tail 1..I-1, a tail alone, the signed extremes,
   zigzag's round trip), timed at 100 MB for I = 1, 2, 4, 8 and delta at
   its 1 MiB basket with I = 8 (events beside ``torch.diff`` and a copy,
   host and device microseconds, exactly one device operation a call, a
   tail included), zigzag in turns with delta; and undelta under stress
   (n = 0, a tail alone, one tile and one tile
   plus or minus an element, the wrap mod 2**(8*I), 100 MB baskets timed
   beside ``torch.cumsum``, all four at pointers I bytes
   off a 16-byte boundary, back-to-back calls of growing size on one
   stream, eight threads on one stream, two streams at once, one device
   operation and no allocation but the output a call); bitshuffle and
   bitunshuffle at their tile edges, misaligned planes, ``out=`` slices and
   inputs I bytes off a 16-byte boundary, the ``lm_head`` row and a tail
   alone, timed at the 607 744-byte ``lm_head`` row beside 1 MiB;
   byteshuffle and byteunshuffle at their tile edges, N % 16 = 1 ... 15,
   the golden's N = 77 100, the 911 616-byte ``lm_head`` basket, ragged
   tails, a tail alone, ``out=`` slices and inputs I bytes off a 16-byte
   boundary, timed at 100 MB for I = 1, 2, 4, 8 beside
   ``view().t().contiguous()`` and a copy; and for every kernel at its
   small shape the host microseconds and device operations a call, from the
   profiler (one for qpack and the bit and byte shuffles, also with a
   tail);
2. the ``ckpt_pr2`` golden checkpoint from CUDA tensors, in every staging x workers
   mode;
3. the paper's NanoAOD-like event tree (2M events): bytes from CUDA tensors
   equal bytes from CPU tensors, and the restore is bitwise; then, as phase
   3b, a save tuned to ``zigzag4`` (one candidate) of a signed int32 tensor
   and the tree's ``Muon_charge`` from CUDA tensors, byte-equal to the CPU
   tensors' save with the same decisions, restored bitwise;
4. the main path: qwen3-8b at full width, depth 1 (its tree checked
   against the published widths), trained by ``repro_torch.launch.train``
   (``build``/``run``) for 4 steps of 8 x 128 tokens with compressed
   gradients and ``remat="full"`` (the configs' default), saved at step 4 (20.1 GB: f32 params and AdamW moments, a
   bf16 residual); the step time, tokens/s, losses, peak memory and one
   profiled step beside the step's bound; the checkpoint restored through
   ``CheckpointManager`` bitwise against the live state, then the depth-1
   model on the restored weights cast to bf16 (a prefill of 2 x 64 tokens
   and 3 decode steps), its logits bit-equal to the live weights'; one
   more step under ``FlopCounterMode``; then, as phase 4c with its own
   seconds, the same checkpoint restored through
   ``CheckpointManager.restore(shardings=...)`` onto ``make_host_mesh()``
   ((1, 1) on cuda:0, NCCL) with the placements of ``param_shardings`` and
   ``opt_shardings``: every leaf a DTensor bitwise equal to the live
   state, its wall beside phase 4's restore; then, as phase 4d, one step
   on the live state under each ``remat`` ("none", "full", "dots"): the
   loss and every gradient bitwise equal, and whole steps in turns, each
   one's time and peak memory, and the depth-1 forward in bf16 with
   ``rms_einsum``, then ``softmax_bf16_probs``, against the default path
   (``VARIANT_RTOL``); as phase 4e, the trainer's token shards served by the
   port's ``BasketServer`` on loopback and read through ``repro://`` URLs
   for three train steps, each batch bitwise the local paths', the server
   closed and no service thread left; and the checkpoint restored with
   ``load_pytree(prefetch=4)``, bitwise, its wall beside phase 4's; then,
   as phase 4b with its own seconds, the same live state saved again by
   ``CheckpointManager(producers=4, tune=True)`` (the buffer merger and the
   codec tuner under the reference's ``checkpoint`` objective), restored
   bitwise, its params cast to bf16 and served (8 requests of 64 tokens,
   greedy) with the tokens of the live weights, the tuner's decisions,
   trials, walls and ratio printed beside the static save's, and
   ``examples/serve_lm_torch.py`` run on the card; then the preemption drill
   on the reduced qwen3-8b, ``python -m repro_torch.launch.train`` in
   child processes that each lead a session of their own: preempted at
   step 3 with exit 17, resumed by the same command without the
   preemption, step 6 against an uninterrupted run within ``DRILL_RTOL``;
5. rwkv6-1.6b served at full width through ``repro_torch.launch.serve``
   with the int8 compressed TP reduction on over a one-rank NCCL group:
   8 requests, greedy; one full-width compressed projection against
   ``torch.matmul``, and the reduced model on the card against the port on
   the CPU;
6. qwen3-8b served at full width and full depth (36 layers, 8.19 B params,
   bf16) through ``repro_torch.launch.serve``: 8 requests of 64 tokens, 4
   slots, 16 new tokens, greedy, after an untimed warm-up run; tok/s,
   prefill and decode-step times beside the decode step's bound, peak
   memory, a profiled window; then the KV cache against a longer prefill
   and a 4096-token prefill with ``q_chunk`` 512 against none (full width,
   depth 2, float32), and the reduced qwen3-8b and gemma2-9b on the card
   against the port on the CPU;
7. jamba-v0.1-52b at full width, depth cut 32 -> 8 (one group of its
   block: 7 mamba, 1 attention, 4 dense FFN, 4 top-2 MoE of 16 experts;
   13.30 B params), and
8. llama4-scout-17b-a16e at full width, depth cut 48 -> 4 (top-1 MoE of 16
   experts and a shared expert; 10.88 B params), each served through
   ``repro_torch.launch.serve`` with phase 6's traffic after an untimed
   warm-up run: tok/s, prefill and decode-step times beside the decode
   step's bound (every weight but the embedding: the dispatch runs every
   expert), peak memory, and a profiled window that times the mamba scan,
   the MoE dispatch, combine and expert GEMMs apart;
9. checks at full width: one llama4-scout MoE layer in float32, dropless,
   against a loop over its experts; one jamba mamba layer, the full pass
   against 64 decode steps (the reference's invariant, max abs 5e-3);
   seamless-m4t-medium whole in float32, its prefill and decode against
   the teacher-forced forward (1e-4) and its bf16 cross cache against the
   encoder's projections; the reduced llama4-scout, jamba and seamless on
   the card against the port on the CPU in float32 (1e-4); one jamba mamba
   layer at S = 4096 through forward and backward with its chunk steps
   recomputed and without, gradients bitwise, the peak of each; and
   ``mamba_bf16_y`` against the default path;
10. the port's dry run: ``python -m repro_torch.launch.dryrun --arch
   qwen3-8b --shape all --mesh both`` in a child process (a fake world of
   256 or 512 ranks, no GPU), all six cells OK (an op DTensor cannot lay
   out fails its cell: the dry run has no fallback), each one's per-device
   peak, roofline terms, mfu_vs_roofline and collectives printed, the
   ``train_4k`` peaks beside those with every activation kept; one cell
   with ``--perf rms_einsum,softmax_bf16_probs``; then phase 4's own cell
   (depth 1, 8 x 128, compressed gradients) on a (1, 1) fake world in
   another child, its argument bytes equal to the live state's and the
   batch's and its dot FLOPs equal to phase 4's FlopCounterMode count, its
   peak and roofline beside phase 4's measured peak and step; the card's
   bf16 GEMM and copy rates beside the data sheet's.

Launch counters are zeroed just before phase 3 and read after it (the
event tree's save and restore), zeroed before phase 3b and read after it
(the zigzag kernels' path), zeroed again just before phase 4's
trainer and read after its save and after its restore (the main path),
around phase 4c's elastic restore and phase 4e's prefetching restore, and
before and after phase 4b's tuned save and its restore,
zeroed before phase 5's serve run and read after it (the rwkv6 serve
path), and again around the timed runs of phases 6, 7 and 8 (the dense,
hybrid and MoE serve paths, which launch none of the port's kernels).  A kernel's ``launches`` in the
JSON record is the sum over phases 3, 3b, 4, 4c, 4e and 4b (the checkpoint
kernels) or phase 5 (qpack, qunpack); zigzag and unzigzag, which replace
no Pallas kernel, carry ``"port_only": true``.  Each phase prints its seconds.  At the end
the script stops multiprocessing's forkserver and resource tracker and
lists its descendants from ``/proc``: if any is still alive after 10 s, or
``multiprocessing`` still has a child, or a thread of the remote service is
alive, it prints them and exits 1 with no result.  The second-to-last line is the
kernels' JSON record, the last line the device record.  Without a CUDA
device it prints no result and exits 1.
"""

import contextlib
import functools
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # float32 outside the tensor cores
BF16_FLOPS = 989e12                # dense bf16 tensor cores
CARDS_USED = 1                     # every phase runs on cuda:0

# phase 5: the serve run, as ``python -m repro_torch.launch.serve`` takes it
SERVE_ARGS = ["--arch", "rwkv6-1.6b", "--requests", "8", "--prompt-len", "64",
              "--slots", "4", "--max-len", "128", "--max-new", "16"]
SERVE_D_MODEL = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def stage_seconds() -> dict:
    """Seconds in each timed stage since the last call (obs histograms:
    per-basket sums; worker-thread stages add up across threads)."""
    from repro_torch import obs
    out: dict = {}
    for key, h in obs.snapshot(reset=True)["hists"].items():
        name = obs.parse_key(key)[0]
        if name.startswith(("engine.pack_s", "ckpt.")):
            out[name] = out.get(name, 0.0) + h["sum"]
    return {k: round(v, 3) for k, v in sorted(out.items())}


def cuda_ms(fn, reps: int, rounds: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events (the median of ``rounds`` such runs): device time for large work,
    the host's enqueue rate for small."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return sorted(per_call)[rounds // 2]


def paired_ms(kern, lib, reps: int, rounds: int = 5) -> tuple:
    """(kernel ms, yardstick ms): :func:`cuda_ms` of each, one round of each
    in turn, medians over ``rounds``, so both see the same host."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kern, reps))
        ls.append(cuda_ms(lib, reps))
    return sorted(ks)[rounds // 2], sorted(ls)[rounds // 2]


def host_us(fn, calls: int = 2000, rounds: int = 5) -> float:
    """Host microseconds per call: ``time.perf_counter`` over ``calls``
    back-to-back calls with no synchronisation inside, the median of
    ``rounds`` such runs (the host is shared, and its noise only adds)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per_call)[rounds // 2]


def device_ops(fn, calls: int = 50) -> tuple:
    """(device microseconds per call, device operations per call, {name:
    count}) over ``calls`` calls under torch.profiler: every kernel, memset
    and memcpy the calls ran, by their own durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs)
    return (busy / calls, sum(e.count for e in evs) / calls,
            {e.key: e.count for e in evs})


def device_ops_best(fn, calls: int = 50, tries: int = 3) -> tuple:
    """:func:`device_ops` of the try that saw the most operations (up to
    ``tries``, stopping at one a call or more): the profiler may drop an
    event, never add one."""
    best = None
    for _ in range(tries):
        got = device_ops(fn, calls)
        if best is None or got[1] > best[1]:
            best = got
        if best[1] >= 1:
            break
    return best


# ---------------------------------------------------------------------------
# phase 1: kernels vs plain versions
# ---------------------------------------------------------------------------

REPLACES = {
    "bitshuffle": "src/repro/kernels/bitshuffle.py:61",
    "bitunshuffle": "src/repro/kernels/bitshuffle.py:81",
    "byteshuffle": "src/repro/kernels/byteshuffle.py:38",
    "byteunshuffle": "src/repro/kernels/byteshuffle.py:55",
    "delta": "src/repro/kernels/delta.py:44",
    "undelta": "src/repro/kernels/delta.py:61",
    "qpack": "src/repro/kernels/qpack.py:51",
    "qunpack": "src/repro/kernels/qpack.py:75",
    # port-only: no Pallas kernel; the reference's host functions
    "zigzag": "src/repro/core/precond.py:180",
    "unzigzag": "src/repro/core/precond.py:192",
}
PORT_ONLY = ("zigzag", "unzigzag")
SOURCE = {
    "bitshuffle": "src/repro_torch/kernels/csrc/bitshuffle.cu",
    "bitunshuffle": "src/repro_torch/kernels/csrc/bitshuffle.cu",
    "byteshuffle": "src/repro_torch/kernels/csrc/byteshuffle.cu",
    "byteunshuffle": "src/repro_torch/kernels/csrc/byteshuffle.cu",
    "delta": "src/repro_torch/kernels/csrc/delta.cu",
    "undelta": "src/repro_torch/kernels/csrc/delta.cu",
    "qpack": "src/repro_torch/kernels/csrc/qpack.cu",
    "qunpack": "src/repro_torch/kernels/csrc/qpack.cu",
    "zigzag": "src/repro_torch/kernels/csrc/zigzag.cu",
    "unzigzag": "src/repro_torch/kernels/csrc/zigzag.cu",
}
# the largest basket the checkpoint path hands each kernel: qwen3-8b's
# ffn.w_gate at depth 1 (f32: bitshuffle4; its bf16 moments: shuffle2),
# the event tree's 1 MiB offset baskets (delta8+shuffle8) and phase 3b's
# tuned 1 MiB baskets of int32 (zigzag4)
MAIN_SHAPES = {
    "bitshuffle": (4, 4096 * 12288 * 4), "bitunshuffle": (4, 4096 * 12288 * 4),
    "byteshuffle": (2, 4096 * 12288 * 2), "byteunshuffle": (2, 4096 * 12288 * 2),
    "delta": (8, 1 << 20), "undelta": (8, 1 << 20),
    "zigzag": (4, 1 << 20), "unzigzag": (4, 1 << 20),
}


# the basket the checkpoint path hands the bit shuffles most: one row of
# qwen3-8b's lm_head, (4096, 151936) f32 (4096 of 6712 launches in phase 4)
LM_HEAD_ROW = 151936 * 4
BIT_SHAPES = {"bitshuffle": (4, LM_HEAD_ROW), "bitunshuffle": (4, LM_HEAD_ROW)}
# ... and the byte shuffles most: three rows of lm_head's bf16 moments
# (2730 of 5268 launches in phase 4)
LM_HEAD_BASKET = 3 * 151936 * 2
BYTE_SHAPES = {"byteshuffle": (2, LM_HEAD_BASKET), "byteunshuffle": (2, LM_HEAD_BASKET)}


def _inputs(name, x, itemsize, K):
    """Arguments for ``name`` on raw bytes ``x`` (planes for bitunshuffle)."""
    if name == "bitunshuffle":
        return (K["bitshuffle"](x, itemsize), itemsize,
                x.numel() - x.numel() % itemsize)
    return (x, itemsize)


def _out_bytes(name, nbytes, itemsize):
    n, tail = divmod(nbytes, itemsize)
    planes = 8 * itemsize * ((n + 7) // 8) + tail
    if name == "bitshuffle":
        return nbytes, planes
    if name == "bitunshuffle":
        return planes, nbytes
    return nbytes, nbytes


def _library_call(name, x, itemsize):
    """One PyTorch call computing the same function, where there is one (the
    byte shuffles' transpose leaves a tail out)."""
    import torch
    n = x.numel() // itemsize
    if name == "byteshuffle":
        return lambda: x[:n * itemsize].view(n, itemsize).t().contiguous()
    if name == "byteunshuffle":
        return lambda: x[:n * itemsize].view(itemsize, n).t().contiguous()
    if x.numel() % itemsize:
        return None
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = x.view(signed[itemsize])
    if name == "undelta":                 # sums kept at the element's width
        return lambda: torch.cumsum(v, 0, dtype=v.dtype)
    if name == "delta":
        zero = v[:1] * 0
        return lambda: torch.diff(v, prepend=zero)
    return None


def phase_kernels(torch, K, ref):
    """K: the kernel wrappers by name; ref: their plain versions."""
    g = torch.Generator(device="cuda").manual_seed(1)
    pairs = {name: (K[name], getattr(ref, name)) for name in K}
    sizes = [1, 7, 8, 77_100, 1_000_003]
    checked = 0
    for itemsize in (1, 2, 4, 8):
        # ... and every basket size the main path hands a kernel
        main = sorted({nb // itemsize for isz, nb in MAIN_SHAPES.values()
                       if isz == itemsize})
        extra = [(1 << 20) // itemsize, 100_000_000 // itemsize] + main
        for n in sizes + sorted(set(extra)):
            nbytes = n * itemsize + n % itemsize          # ragged tails too
            x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                              device="cuda", generator=g)
            for name, (kern, plain) in pairs.items():
                args = _inputs(name, x, itemsize, K)
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = (got.int() - want.int()).abs().max().item() \
                        if got.shape == want.shape else "shape"
                    raise AssertionError(f"{name} itemsize={itemsize} "
                                         f"nbytes={nbytes}: differs ({bad})")
                checked += 1
            back = K["bitunshuffle"](K["bitshuffle"](x, itemsize), itemsize,
                                     nbytes - nbytes % itemsize)
            assert torch.equal(back, x)
            for fwd, inv in (("byteshuffle", "byteunshuffle"),
                             ("delta", "undelta"), ("zigzag", "unzigzag")):
                assert torch.equal(K[inv](K[fwd](x, itemsize), itemsize), x)
    log(f"phase 1: {checked} kernel runs byte-equal to their plain versions "
        f"(itemsizes 1/2/4/8, element counts {sizes} + 1 MiB + 100 MB + the "
        f"main path's baskets {sorted(set(MAIN_SHAPES.values()))}, ragged tails)")

    rows, extra = [], {}
    log("kernel        itemsize  bytes        ms        GB/s    bound_ms  "
        "plain_ms  library_ms  d2d_copy_ms")
    for label, shapes in (("1 MiB", {k: (v[0], 1 << 20) for k, v in MAIN_SHAPES.items()}),
                          ("lm_head", BIT_SHAPES), ("basket", BYTE_SHAPES),
                          ("main", MAIN_SHAPES)):
        for name, (itemsize, nbytes) in shapes.items():
            kern, plain = pairs[name]
            x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                              device="cuda", generator=g)
            args = _inputs(name, x, itemsize, K)
            # small calls: the host's rate, so medians of 5 rounds in turns
            reps, rounds = (200, 5) if nbytes <= (1 << 20) else (20, 1)
            lib = _library_call(name, x, itemsize)
            if lib is not None:
                ms, lib_ms = paired_ms(lambda: kern(*args), lib, reps, rounds)
            else:
                ms, lib_ms = cuda_ms(lambda: kern(*args), reps, rounds), None
            plain_ms = cuda_ms(lambda: plain(*args), max(reps // 10, 3))
            dst = torch.empty_like(x)
            copy_ms = cuda_ms(lambda: dst.copy_(x), reps, rounds)
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item() \
                if got.shape == want.shape and got.numel() else 0
            if not torch.equal(got, want):
                raise AssertionError(f"{name} itemsize={itemsize} nbytes={nbytes}"
                                     f" [{label}]: differs (max abs err {err})")
            b_in, b_out = _out_bytes(name, nbytes, itemsize)
            bound_ms = (b_in + b_out) / HBM_BYTES_PER_S * 1e3
            lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"{name:13s} {itemsize:8d}  {nbytes:11d}  {ms:8.4f}  "
                f"{(b_in + b_out) / ms / 1e6:7.1f}  {bound_ms:8.4f}  "
                f"{plain_ms:8.4f}  {lib_txt:>10}  {copy_ms:.4f}   [{label}]")
            if label in ("lm_head", "basket"):
                extra[name] = {f"{label}_bytes": nbytes, f"{label}_ms": ms,
                               f"{label}_bound_ms": bound_ms,
                               f"{label}_plain_ms": plain_ms,
                               f"{label}_d2d_copy_ms": copy_ms}
                if lib_ms is not None:
                    extra[name][f"{label}_library_ms"] = lib_ms
            if label == "main":
                rows.append({"name": name, "route": "cuda",
                             "source": SOURCE[name], "replaces": REPLACES[name],
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": "bytes", "library_ms": lib_ms,
                             "itemsize": itemsize, "bytes": nbytes,
                             "d2d_copy_ms": copy_ms, **extra.get(name, {})})
                if name in PORT_ONLY:
                    rows[-1]["port_only"] = True
    return rows


# ---------------------------------------------------------------------------
# phase 1, continued: bitshuffle / bitunshuffle at the edges of their design
# ---------------------------------------------------------------------------

def phase_bitshuffle(torch, K, ref):
    """bitshuffle and bitunshuffle byte-equal to their plain versions at the
    sizes their tiles, plane alignment and narrow paths turn on."""
    g = torch.Generator(device="cuda").manual_seed(6)
    fwd, inv = K["bitshuffle"], K["bitunshuffle"]
    tile = 1024
    # tile edges; ceil(N/8) % 4 = 1, 2, 3 (every plane after the first
    # misaligned; 77 100 is the golden's w)
    counts = [31, 33, tile - 1, tile + 1, 3 * tile - 1, 3 * tile + 1,
              149 * tile - 1, 149 * tile + 1, 77_092, 77_100, 77_108]
    checked = narrow = 0

    def check(what, itemsize, x, at_out):
        nonlocal checked, narrow
        n = x.numel() // itemsize
        planes = ref.bitshuffle(x, itemsize)
        out_p = _unaligned(torch, torch.empty_like(planes), at_out)
        in_p = _unaligned(torch, planes, at_out)
        out_x = _unaligned(torch, torch.empty_like(x), at_out)
        got = fwd(x, itemsize, out=out_p)
        back = inv(in_p, itemsize, n * itemsize, out=out_x)
        want_back = ref.bitunshuffle(planes, itemsize, n * itemsize)
        torch.cuda.synchronize()
        if not torch.equal(got, planes):
            raise AssertionError(f"bitshuffle itemsize={itemsize} {what}: differs")
        if not (torch.equal(back, want_back) and torch.equal(back, x)):
            raise AssertionError(f"bitunshuffle itemsize={itemsize} {what}: differs")
        checked += 2
        # the launchers' conditions for their narrow paths
        ragged = (n + 7) // 8 % 4 != 0
        narrow += (x.data_ptr() % 16 != 0 or ragged or out_p.data_ptr() % 4 != 0)
        narrow += (ragged or in_p.data_ptr() % 4 != 0 or out_x.data_ptr() % 16 != 0)

    for itemsize in (1, 2, 4, 8):
        sizes = [n * itemsize + t for n in counts for t in sorted({0, itemsize - 1})]
        sizes += [LM_HEAD_ROW, LM_HEAD_ROW + itemsize - 1, itemsize - 1]
        for nbytes in sizes:
            if nbytes == 0:
                continue
            x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                              generator=g)
            check(f"{nbytes} bytes", itemsize, x, 0)
            # out= slices and the input I bytes past a 16-byte boundary
            check(f"{nbytes} bytes, out= {itemsize} B off", itemsize, x, itemsize)
            check(f"{nbytes} bytes, input {itemsize} B off", itemsize,
                  _unaligned(torch, x, itemsize), 0)
    log(f"phase 1: {checked} bitshuffle/bitunshuffle runs byte-equal to the plain "
        f"versions (itemsizes 1/2/4/8, element counts {counts}, the lm_head row "
        f"of {LM_HEAD_ROW} bytes, a tail alone, ragged tails; out= slices, inputs "
        f"and planes I bytes past a 16-byte boundary; {narrow} through a narrow "
        "path)")


# ---------------------------------------------------------------------------
# phase 1, continued: byteshuffle / byteunshuffle at the edges of their design
# ---------------------------------------------------------------------------

BYTE_LARGE = 100_000_000          # bytes: timed at I = 1, 2, 4, 8


def _plane_width(n, ptr):
    """csrc/byteshuffle.cu plane_width: the planes' access width."""
    if n % 16 == 0 and ptr % 16 == 0:
        return 16
    return 4 if n % 4 == 0 and ptr % 4 == 0 else 1


def phase_byteshuffle(torch, K, ref):
    """byteshuffle and byteunshuffle byte-equal to their plain versions at
    the sizes their tiles, grid, plane alignment and narrow paths turn on,
    then timed at 100 MB for every itemsize; returns {name: {itemsize:
    times}}."""
    from repro_torch.kernels import byteshuffle as bmod
    g = torch.Generator(device="cuda").manual_seed(7)
    fwd, inv = K["byteshuffle"], K["byteunshuffle"]
    t, wide = bmod.TILE_ELEMS, bmod.WIDE_TILES
    # tile edges; N % 16 = 1 ... 15 (narrow planes); the golden's w; the
    # lm_head basket (891 tiles, four warps a block, the last block short);
    # the grid's switch to four warps a block
    counts = [1, 15, 16, 17, t - 1, t + 1, 3 * t - 1, 3 * t + 1]
    counts += [4096 + r for r in range(1, 16)]
    counts += [77_100, LM_HEAD_BASKET // 2, wide * t - 1, wide * t + 1]
    checked = narrow = 0

    def check(what, itemsize, x, at_out):
        nonlocal checked, narrow
        n = x.numel() // itemsize
        planes = ref.byteshuffle(x, itemsize)
        out_p = _unaligned(torch, torch.empty_like(planes), at_out)
        in_p = _unaligned(torch, planes, at_out)
        out_x = _unaligned(torch, torch.empty_like(x), at_out)
        got = fwd(x, itemsize, out=out_p)
        back = inv(in_p, itemsize, out=out_x)
        want_back = ref.byteunshuffle(planes, itemsize)
        torch.cuda.synchronize()
        if not torch.equal(got, planes):
            raise AssertionError(f"byteshuffle itemsize={itemsize} {what}: differs")
        if not (torch.equal(back, want_back) and torch.equal(back, x)):
            raise AssertionError(f"byteunshuffle itemsize={itemsize} {what}: differs")
        checked += 2
        # the launchers' conditions for their narrow paths
        narrow += x.data_ptr() % 16 != 0 or _plane_width(n, out_p.data_ptr()) != 16
        narrow += _plane_width(n, in_p.data_ptr()) != 16 or out_x.data_ptr() % 16 != 0

    for itemsize in (1, 2, 4, 8):
        sizes = [n * itemsize + r for n in counts for r in sorted({0, itemsize - 1})]
        sizes += [itemsize - 1] if itemsize > 1 else []          # a tail alone
        for nbytes in sizes:
            x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                              generator=g)
            check(f"{nbytes} bytes", itemsize, x, 0)
            # out= slices and the input I bytes past a 16-byte boundary
            check(f"{nbytes} bytes, out= {itemsize} B off", itemsize, x, itemsize)
            check(f"{nbytes} bytes, input {itemsize} B off", itemsize,
                  _unaligned(torch, x, itemsize), 0)
    log(f"phase 1: {checked} byteshuffle/byteunshuffle runs byte-equal to the "
        f"plain versions (itemsizes 1/2/4/8, element counts {counts}, a tail "
        "alone, ragged tails; out= slices, inputs and planes I bytes past a "
        f"16-byte boundary; {narrow} through a narrow path)")

    large = {"byteshuffle": {}, "byteunshuffle": {}}
    log("kernel         itemsize  bytes        ms        GB/s    bound_ms  "
        "library_ms  d2d_copy_ms   (library: view().t().contiguous())")
    x = torch.randint(0, 256, (BYTE_LARGE,), dtype=torch.uint8, device="cuda",
                      generator=g)
    dst = torch.empty_like(x)
    bound_ms = 2 * BYTE_LARGE / HBM_BYTES_PER_S * 1e3
    for itemsize in (1, 2, 4, 8):
        for name in ("byteshuffle", "byteunshuffle"):
            kern = K[name]
            got = kern(x, itemsize)
            torch.cuda.synchronize()
            if not torch.equal(got, getattr(ref, name)(x, itemsize)):
                raise AssertionError(f"{name} itemsize={itemsize} [100 MB]: differs")
            ms, lib_ms = paired_ms(lambda: kern(x, itemsize, out=dst),
                                   _library_call(name, x, itemsize), 20, 3)
            copy_ms = cuda_ms(lambda: dst.copy_(x), 20, 3)
            large[name][itemsize] = {"bytes": BYTE_LARGE, "ms": ms, "library_ms": lib_ms,
                                     "bound_ms": bound_ms, "d2d_copy_ms": copy_ms}
            log(f"{name:14s} {itemsize:8d}  {BYTE_LARGE:11d}  {ms:8.4f}  "
                f"{2 * BYTE_LARGE / ms / 1e6:7.1f}  {bound_ms:8.4f}  {lib_ms:10.4f}  "
                f"{copy_ms:.4f}   [100 MB]")
    return large


# ---------------------------------------------------------------------------
# phase 1, continued: qpack / qunpack vs their plain versions
# ---------------------------------------------------------------------------

def _serve_rows():
    """(R, C) the serve phase hands qpack/qunpack: a prefill of every slot
    at the prompt length, then one token per slot per decode step."""
    a = dict(zip(SERVE_ARGS[::2], SERVE_ARGS[1::2]))
    slots, plen = int(a["--slots"]), int(a["--prompt-len"])
    return [(slots * plen, SERVE_D_MODEL), (slots, SERVE_D_MODEL)]


def _quant_input(torch, g, rows, cols, dtype, kind):
    """A (rows, cols) float32 matrix of one kind, cast to ``dtype``."""
    x = torch.randn((rows, cols), generator=g, device="cuda") * 3
    if kind == "zeros":                    # zero rows among the others
        x[::3] = 0.0
    elif kind == "ties":
        # amax 127 * 2**e makes the scale 2**e exactly: x / scale = k + 0.5
        k = torch.randint(-127, 127, (rows, cols), generator=g, device="cuda")
        e = torch.randint(-6, 6, (rows, 1), generator=g, device="cuda").float()
        x = (k.float() + 0.5) * torch.exp2(e)
        x[:, 0] = 127.0 * torch.exp2(e[:, 0])
    elif kind == "halfway":
        # x / scale within an ulp of k + 0.5 for a scale that is no power of 2
        amax = torch.rand((rows, 1), generator=g, device="cuda") * 10 + 0.1
        k = torch.randint(-126, 126, (rows, cols), generator=g, device="cuda")
        x = (k.float() + 0.5) * (amax * (1.0 / 127.0))
        x[:, :1] = amax
    elif kind == "nonfinite":
        # among finite rows: a NaN, +inf, -inf, both infinities, and a
        # subnormal amax whose scale underflows to 0
        r = torch.arange(rows, device="cuda")
        c = torch.randint(0, cols, (rows,), generator=g, device="cuda")
        x[r[0::6], c[0::6]] = float("nan")
        x[r[1::6], c[1::6]] = float("inf")
        x[r[2::6], c[2::6]] = -float("inf")
        x[r[3::6], c[3::6]] = float("inf")
        x[r[3::6], (c[3::6] + 1) % cols] = -float("inf")
        x[4::6] = 0.0
        x[r[4::6], c[4::6]] = 3e-45
    elif kind == "subnormal":
        # where XLA's flushing of subnormals decides (ROADMAP C 2): a normal
        # amax whose scale underflows, a subnormal amax, subnormal elements
        # beside an amax of 127 * FLT_MIN and one step below it, and
        # subnormals among normal values
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand((rows, cols), generator=g, device="cuda") * 2 - 1
        x[0::5] = u[0::5] * 1e-37
        x[1::5] = u[1::5] * 1e-40
        x[2::5] = u[2::5] * tiny
        x[2::5, 0] = 127 * tiny
        x[3::5] = u[3::5] * tiny
        x[3::5, 0] = torch.nextafter(torch.tensor(127 * tiny, device="cuda"),
                                     torch.tensor(0.0, device="cuda"))
        x[4::5, ::2] = u[4::5, ::2] * 1e-39
    return x.to(dtype)


QUNPACK_SLOWEST_MS = 0.120        # (32768, 2048) bf16, k = 1: half its bound's rate


def _unaligned(torch, t, at: int = 1):
    """A copy of ``t`` whose data starts ``at`` bytes past a 16-byte
    boundary: qunpack's scalar path, the bit shuffles' narrow ones."""
    raw = torch.empty(t.numel() * t.element_size() + 32, dtype=torch.uint8,
                      device=t.device)
    base = (-raw.data_ptr()) % 16 + at
    out = raw[base:base + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == at % 16
    return out


def phase_quant_kernels(torch, K, ref):
    """qpack/qunpack bit-equal to their plain versions on the card, then
    timed at the serve path's decode (4, 2048) and prefill (256, 2048)
    shapes and at one prefill_32k sequence of rwkv6's width, (32768, 2048),
    qunpack beside ``torch.mul(q, s)``.  The JSON row's own keys hold the
    (32768, 2048) times, as in earlier runs; ``decode_*`` and ``prefill_*``
    keys hold the serve shapes', where the serve path launches both most."""
    g = torch.Generator(device="cuda").manual_seed(2)
    types = (torch.float32, torch.bfloat16)
    shapes = [(r, c) for r in (1, 4, 256, 32768) for c in (1, 7, 2047, 2048, 7168)]
    shapes += _serve_rows()
    checked = unaligned = 0
    for rows, cols in shapes:
        for kind in ("random", "zeros", "ties", "halfway", "nonfinite", "subnormal"):
            if kind in ("ties", "halfway") and (cols < 2 or rows * cols > 1 << 24):
                continue
            for dtype in types:
                x = _quant_input(torch, g, rows, cols, dtype, kind)
                for zero_scale in (0.0, 1.0):
                    (q, s), (rq, rs) = K["qpack"](x, zero_scale), ref.qpack(x, zero_scale)
                    torch.cuda.synchronize()
                    if not (same_bits(q, rq) and same_bits(s, rs)):
                        raise AssertionError(
                            f"qpack {rows}x{cols} {dtype} {kind} zero_scale="
                            f"{zero_scale}: differs from the plain version")
                    checked += 1
                for k in (1, 3):
                    qk = q.expand(k, rows, cols).contiguous()
                    if k > 1:
                        qk[1:] = torch.randint(-127, 128, (k - 1, rows, cols), generator=g,
                                               device="cuda", dtype=torch.int8)
                    sk = torch.cat([s[None], torch.rand((k - 1, rows, 1), generator=g,
                                                        device="cuda")])
                    # the gathered payloads as parallel/compressed.py hands them
                    cases = [(qk, "")]
                    if kind == "random" and dtype == torch.float32:
                        cases.append((_unaligned(torch, qk), " unaligned"))
                    for qc, note in cases:
                        for out in types:
                            got = K["qunpack"](qc, sk, out)
                            want = ref.qunpack(qk, sk, out)
                            torch.cuda.synchronize()
                            if not same_bits(got, want):
                                raise AssertionError(
                                    f"qunpack k={k} {rows}x{cols} {out} {kind}{note}: "
                                    "differs from the plain version")
                            checked += 1
                            unaligned += bool(note)
    log(f"phase 1: {checked} qpack/qunpack runs bit-equal to their plain versions "
        f"(R x C over {{1, 4, 256, 32768}} x {{1, 7, 2047, 2048, 7168}} and the "
        f"serve path's prefill and decode {_serve_rows()}; f32/bf16 in and out; "
        f"k = 1, 3; random, zero, tie, halfway, non-finite and subnormal rows; "
        f"zero-row scale "
        f"0 and 1; "
        f"{unaligned} qunpack runs with payloads 1 byte off a 16-byte boundary)")

    rows_out = []
    log("kernel    shape          ms        GB/s    bound_ms  plain_ms  "
        "library_ms   (library: torch.mul(q, s))")
    shapes = (("decode", _serve_rows()[1]), ("prefill", _serve_rows()[0]),
              ("prefill_32k", (32768, SERVE_D_MODEL)))
    targets = []
    for name in ("qpack", "qunpack"):
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name], "launches": 0, "bound_by": "bytes"}
        for label, (rows, cols) in shapes:
            x = torch.randn((rows, cols), generator=g, device="cuda")
            q, s = K["qpack"](x, 1.0)
            if name == "qpack":
                def kern(): return K["qpack"](x, 1.0)
                def plain(): return ref.qpack(x, 1.0)
                lib = None                  # no single PyTorch call quantizes
                nbytes = 5 * rows * cols + 4 * rows
            else:
                qk, sk = q[None], s[None]   # k = 1: the one-rank serve path
                def kern(): return K["qunpack"](qk, sk, torch.bfloat16)
                def plain(): return ref.qunpack(qk, sk, torch.bfloat16)
                def lib(): return torch.mul(q, s)
                nbytes = 3 * rows * cols + 4 * rows
            reps = 100 if rows * cols > 1 << 20 else 1000
            if lib is not None:
                ms, lib_ms = paired_ms(kern, lib, reps)
            else:
                ms, lib_ms = cuda_ms(kern, reps, 5), None
            plain_ms = cuda_ms(plain, max(reps // 10, 3))
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if name == "qpack":
                err = max((got[0].int() - want[0].int()).abs().max().item(),
                          (got[1] - want[1]).abs().max().item())
                same = same_bits(got[0], want[0]) and same_bits(got[1], want[1])
            else:
                err = (got.float() - want.float()).abs().max().item()
                same = same_bits(got, want)
            if not same:
                raise AssertionError(f"{name} {rows}x{cols} [{label}]: differs "
                                     f"(max abs err {err})")
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"{name:8s}  {rows:6d}x{cols:<6d} {ms:8.4f}  {nbytes / ms / 1e6:7.1f}  "
                f"{bound_ms:8.4f}  {plain_ms:8.4f}  {lib_txt:>10}   [{label}]")
            if label == "prefill_32k":
                row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, library_ms=lib_ms, shape=[rows, cols],
                           dtype="f32 in" if name == "qpack" else "bf16 out, k=1")
            else:
                row.update({f"{label}_shape": [rows, cols], f"{label}_ms": ms,
                            f"{label}_plain_ms": plain_ms,
                            f"{label}_bound_ms": bound_ms,
                            f"{label}_library_ms": lib_ms})
            if name == "qunpack" and label == "decode":
                targets.append(f"qunpack {rows}x{cols}: {ms:.4f} ms vs torch.mul "
                               f"{lib_ms:.4f} ms: {'met' if ms <= lib_ms else 'missed'}")
            if name == "qunpack" and label == "prefill_32k":
                ok = ms <= QUNPACK_SLOWEST_MS and ms < lib_ms
                targets.append(f"qunpack {rows}x{cols}: {ms:.4f} ms vs "
                               f"{QUNPACK_SLOWEST_MS} ms (half the {bound_ms:.4f} ms "
                               f"bound's rate) and torch.mul {lib_ms:.4f} ms: "
                               f"{'met' if ok else 'missed'}")
        rows_out.append(row)
    for t in targets:
        log(f"phase 1: target {t}")
    return rows_out


# ---------------------------------------------------------------------------
# phase 1, continued: qpack at the edges of its design
# ---------------------------------------------------------------------------

QPACK_LARGE_MS = 0.134            # (32768, 2048) f32: 75 % of the bound's rate
QPACK_DEVICE_US = 2.5             # a call at the decode shape (4, 2048)


def _qpack_row_elements():
    """From csrc/qpack.cu: the longest row one chunk holds, a block's
    threads times a thread's group; longer rows go in chunks."""
    import math
    import re
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "qpack.cu")) as f:
        src = f.read()
    return math.prod(int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
                     for name in ("kRowThreads", "kGroup"))


def phase_qpack(torch, K, ref):
    """qpack bit-equal to its plain version where its launch changes path:
    C at a block's one warp (512), its 128 and 256 threads (2048, 4096: past
    that, chunks read again) and a row of 16 chunks, each +-1, at R = 3 and
    at R on each side of the card's 132 SMs; C % 16 = 1 ... 15; inputs 4
    and 8 bytes past a 16-byte boundary; random, zero, tie, halfway,
    non-finite and subnormal rows, zero-row scale 0 and 1.  Then
    (32768, 2048) f32 and bf16 timed; returns {dtype: times}."""
    g = torch.Generator(device="cuda").manual_seed(8)
    chunk = _qpack_row_elements()
    both = (torch.float32, torch.bfloat16)
    cases = [(rows, cols + d, both) for rows in (3, 131, 133)
             for cols in (512, chunk // 2, chunk) for d in (-1, 0, 1)]
    cases += [(3, 16 * chunk + d, both) for d in (-1, 0, 1)]
    cases += [(rows, chunk // 2 - 16 + r, both) for r in range(1, 16) for rows in (5, 133)]
    checked = shifted = 0
    for rows, cols, dtypes in cases:
        for dtype in dtypes:
            for kind in ("random", "zeros", "ties", "halfway", "nonfinite",
                         "subnormal"):
                x = _quant_input(torch, g, rows, cols, dtype, kind)
                inputs = [(x, "")]
                if kind in ("random", "nonfinite"):
                    inputs += [(_unaligned(torch, x, at), f", input {at} B off")
                               for at in (4, 8)]
                for xi, note in inputs:
                    for zero_scale in (0.0, 1.0):
                        (q, s), (rq, rs) = K["qpack"](xi, zero_scale), ref.qpack(x, zero_scale)
                        torch.cuda.synchronize()
                        if not (same_bits(q, rq) and same_bits(s, rs)):
                            raise AssertionError(
                                f"qpack {rows}x{cols} {dtype} {kind}{note} zero_scale="
                                f"{zero_scale}: differs from the plain version")
                        checked += 1
                        shifted += bool(note)
    log(f"phase 1: {checked} qpack runs bit-equal to the plain version at its edges "
        f"(R = 3, 131, 133 at C = 512, {chunk // 2}, {chunk} +-1; C = {16 * chunk} +-1; "
        f"C % 16 = 1 ... 15; "
        f"random, zero, tie, halfway, non-finite and subnormal rows; zero-row "
        f"scale 0 and 1; {shifted} with the input 4 or 8 bytes past a 16-byte boundary)")
    large = {}
    for dtype in both:
        x = torch.randn((32768, SERVE_D_MODEL), generator=g, device="cuda").to(dtype)
        (q, s), (rq, rs) = K["qpack"](x, 1.0), ref.qpack(x, 1.0)
        torch.cuda.synchronize()
        if not (same_bits(q, rq) and same_bits(s, rs)):
            raise AssertionError(f"qpack 32768x{SERVE_D_MODEL} {dtype}: differs")
        ms = cuda_ms(lambda: K["qpack"](x, 1.0), 100, 5)
        nbytes = x.numel() * (x.element_size() + 1) + 4 * x.shape[0]
        name = str(dtype).split(".")[-1]
        large[name] = {"shape": list(x.shape), "ms": ms,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        log(f"qpack     32768x{SERVE_D_MODEL} {name:8s} {ms:8.4f} ms  "
            f"{nbytes / ms / 1e6:7.1f} GB/s  bound {large[name]['bound_ms']:.4f} ms "
            f"({100 * large[name]['bound_ms'] / ms:.0f} %)")
    return large


# ---------------------------------------------------------------------------
# phase 1, continued: the undelta scan under stress, and the launch path's
# host / device split
# ---------------------------------------------------------------------------

SCAN_LARGE = 100_000_000          # bytes: an offset branch that is one basket
UNDELTA_SLOWEST_MS = 0.119        # 100 MB: half the bound's rate


def _scan_equal(torch, ref, name, got, x, itemsize, what):
    torch.cuda.synchronize()
    want = getattr(ref, name)(x, itemsize)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} itemsize={itemsize} [{what}]: differs "
                             "from the plain version")


def _one_op(torch, fn, kernel):
    """Device operations of a call of ``fn``: exactly one, ``kernel``'s
    (the profiler may drop an event, never add one: up to five tries)."""
    d, per_call, names = device_ops_best(fn, 20, tries=5)
    assert per_call == 1 and len(names) == 1 and \
        re.search(rf"\b{kernel}_kernel<", next(iter(names))), (kernel, names)
    return d, per_call


DELTA_LARGE_MS = 0.072            # 100 MB, every I: 83 % of the bound's rate
DELTA_DEVICE_US = (1.3, 1.5)      # 1 MiB, I = 8: the launch's floor


def phase_scan(torch, K, ref):
    """The forward maps (delta, zigzag, unzigzag) and undelta byte-equal to
    their plain versions over the cases their designs turn on; all four
    timed at 100 MB for I = 1, 2, 4, 8 and delta at its 1 MiB basket
    (events, host and device µs, operations a call, beside ``torch.diff``
    and a copy); returns {name: {itemsize: times}}."""
    import threading
    from repro_torch.kernels import delta as dmod
    g = torch.Generator(device="cuda").manual_seed(3)
    undelta = K["undelta"]
    maps = ("delta", "zigzag", "unzigzag")

    def rand(nbytes):
        return torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                             generator=g)

    large = {name: {} for name in ("delta", "undelta", "zigzag", "unzigzag")}
    targets = []
    log("kernel    itemsize  bytes        ms        GB/s    bound_ms  library_ms"
        "  copy_ms   host_us  device_us  ops   (library: torch.diff, "
        "torch.cumsum; beside zigzag, delta)")
    for itemsize in (1, 2, 4, 8):
        x = rand(SCAN_LARGE)
        dst = torch.empty_like(x)
        copy_ms = cuda_ms(lambda: dst.copy_(x), 20, 3)
        bound_ms = 2 * SCAN_LARGE / HBM_BYTES_PER_S * 1e3
        for name in ("delta", "undelta", "zigzag", "unzigzag"):
            kern = K[name]
            got = kern(x, itemsize)
            _scan_equal(torch, ref, name, got, x, itemsize, "100 MB")
            del got
            lib = _library_call(name, x, itemsize) if name in ("delta", "undelta") \
                else (lambda: K["delta"](x, itemsize, out=dst))
            ms, lib_ms = paired_ms(lambda: kern(x, itemsize, out=dst) if name in maps
                                   else kern(x, itemsize), lib, 20, 3)
            row = {"bytes": SCAN_LARGE, "ms": ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "d2d_copy_ms": copy_ms}
            txt = ""
            if name in maps:
                h = host_us(lambda: kern(x, itemsize, out=dst), calls=100, rounds=3)
                d, ops = _one_op(torch, lambda: kern(x, itemsize, out=dst), name)
                row.update(host_us=h, device_us=d, device_ops_per_call=ops)
                txt = f"  {h:8.2f}  {d:9.2f}  {ops:g}"
            large[name][itemsize] = row
            log(f"{name:9s} {itemsize:8d}  {SCAN_LARGE:11d}  {ms:8.4f}  "
                f"{2 * SCAN_LARGE / ms / 1e6:7.1f}  {bound_ms:8.4f}  "
                f"{lib_ms:10.4f}  {copy_ms:7.4f}{txt}   [100 MB]")
            if name == "undelta" and itemsize in (4, 8):
                targets.append(f"undelta {itemsize} x 100 MB: {ms:.4f} ms vs "
                               f"{UNDELTA_SLOWEST_MS} ms (half the {bound_ms:.4f} ms "
                               f"bound's rate): "
                               f"{'met' if ms <= UNDELTA_SLOWEST_MS else 'missed'}")
            if name == "delta":
                targets.append(
                    f"delta {itemsize} x 100 MB: {ms:.4f} ms vs {DELTA_LARGE_MS} ms "
                    f"({100 * bound_ms / ms:.0f} % of the {bound_ms:.4f} ms bound; "
                    f"copy {copy_ms:.4f} ms, torch.diff {lib_ms:.4f} ms): "
                    f"{'met' if ms <= DELTA_LARGE_MS else 'missed'}")
            if name in ("zigzag", "unzigzag"):
                targets.append(
                    f"{name} {itemsize} x 100 MB: {ms:.4f} ms vs delta's "
                    f"{lib_ms:.4f} ms in turns, within 5 %: "
                    f"{'met' if ms <= 1.05 * lib_ms else 'missed'}")
        del x, dst

    # delta at the main path's basket, and with a tail: one operation a call
    for label, itemsize, nbytes in (("1 MiB", 8, 1 << 20), ("1 MiB + tail", 8, (1 << 20) + 3),
                                    ("1 MiB", 4, 1 << 20), ("1 MiB + tail", 4, (1 << 20) + 3)):
        x, out = rand(nbytes), torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        for name in (maps if itemsize == 4 else ("delta",)):
            kern = K[name]
            _scan_equal(torch, ref, name, kern(x, itemsize), x, itemsize, label)
            lib = _library_call(name, x, itemsize)
            if lib is None:
                ms, lib_ms = cuda_ms(lambda: kern(x, itemsize, out=out), 200, 5), None
            else:
                ms, lib_ms = paired_ms(lambda: kern(x, itemsize, out=out), lib, 200)
            copy_ms = cuda_ms(lambda: out.copy_(x), 200, 5)
            h = host_us(lambda: kern(x, itemsize, out=out))
            d, ops = _one_op(torch, lambda: kern(x, itemsize, out=out), name)
            bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            large[name][f"{label}, I = {itemsize}"] = {
                "bytes": nbytes, "ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                "d2d_copy_ms": copy_ms, "host_us": h, "device_us": d,
                "device_ops_per_call": ops}
            lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"{name:9s} {itemsize:8d}  {nbytes:11d}  {ms:8.4f}  "
                f"{2 * nbytes / ms / 1e6:7.1f}  {bound_ms:8.4f}  {lib_txt:>10}  "
                f"{copy_ms:7.4f}  {h:8.2f}  {d:9.2f}  {ops:g}   [{label}]")
            if name == "delta" and label == "1 MiB" and itemsize == 8:
                lo, hi = DELTA_DEVICE_US
                targets.append(f"delta 1 MiB, I = 8, device us a call: {d:.2f} in "
                               f"[{lo}, {hi}]: {'met' if d <= hi else 'missed'}; "
                               f"events {ms:.4f} ms, host {h:.2f} us")
    for name in maps:
        for label in ("1 MiB + tail, I = 8", "1 MiB + tail, I = 4"):
            if label in large[name]:
                targets.append(f"{name} {label}: operations a call "
                               f"{large[name][label]['device_ops_per_call']:g} "
                               "(asserted): met")

    # the forward maps at the lengths their vector path turns on: 0, 1, 15,
    # 16, 17 vectors, a block and the first deep grid, each +-1 element,
    # with every tail 1..I-1 (n = 0: a tail alone)
    checked = 0
    deep = 263 * 1024 + 1          # vectors: the deep grid's first length
    for itemsize in (1, 2, 4, 8):
        v = 16 // itemsize
        for n in sorted({max(0, c * v + d) for c in (0, 1, 15, 16, 17, 256, deep)
                         for d in (-1, 0, 1)}):
            for tail in range(itemsize):
                x = rand(n * itemsize + tail)
                for name in maps:
                    _scan_equal(torch, ref, name, K[name](x, itemsize), x, itemsize,
                                f"{n} elements + {tail}")
                    checked += 1
                back = K["unzigzag"](K["zigzag"](x, itemsize), itemsize)
                assert torch.equal(back, x), (itemsize, n, tail)
        # every signed width's extremes
        info = torch.iinfo(ref._SIGNED[itemsize])
        ext = torch.tensor([info.min, info.max, -1, 0, 1] * 1000,
                           dtype=ref._SIGNED[itemsize], device="cuda").view(torch.uint8)
        for name in maps:
            _scan_equal(torch, ref, name, K[name](ext, itemsize), ext, itemsize,
                        "extremes")
            checked += 1
        assert torch.equal(K["unzigzag"](K["zigzag"](ext, itemsize), itemsize), ext)

    tile = dmod.TILE_BYTES
    for itemsize in (1, 2, 4, 8):
        # n = 0, a tail alone, one tile, one tile -/+ an element, several
        for nbytes in (0, itemsize - 1, tile, tile - itemsize, tile + itemsize,
                       7 * tile + itemsize - 1):
            x = rand(nbytes)
            _scan_equal(torch, ref, "undelta", undelta(x, itemsize), x, itemsize,
                        f"{nbytes} bytes")
            checked += 1
        # the wrap mod 2**(8*I): every element the largest value less 3
        big = torch.full((3 * tile // itemsize,), -4, dtype=ref._SIGNED[itemsize],
                         device="cuda").view(torch.uint8)
        _scan_equal(torch, ref, "undelta", undelta(big, itemsize), big, itemsize,
                    "wrap")
        checked += 1
        # pointers I bytes off a 16-byte boundary: the scalar staging
        for nbytes in (1000 * itemsize + itemsize - 1, (3 << 20) + 5):
            pad = rand(nbytes + 32)
            base = (-pad.data_ptr()) % 16
            for lo_in, lo_out in ((itemsize, 0), (0, itemsize), (itemsize, itemsize)):
                x = pad[base + lo_in:base + lo_in + nbytes]
                out = torch.empty(nbytes + 32, dtype=torch.uint8, device="cuda")
                obase = (-out.data_ptr()) % 16
                dst = out[obase + lo_out:obase + lo_out + nbytes]
                assert (x.data_ptr() % 16, dst.data_ptr() % 16) == \
                    (lo_in % 16, lo_out % 16)
                for name in ("delta", "undelta", "zigzag", "unzigzag"):
                    got = K[name](x, itemsize, out=dst)
                    _scan_equal(torch, ref, name, got, x, itemsize,
                                f"offsets {lo_in}/{lo_out}, {nbytes} bytes")
                    checked += 1

    # back-to-back calls on one (fresh) stream, growing: the workspace is
    # reused between launches and regrown (and replaced) while earlier
    # launches may still run; no synchronisation until all are checked
    side = torch.cuda.Stream()
    grow = [(rand(int(tile * 1.7 ** k) + k % 8), (8, 4, 2, 1)[k % 4])
            for k in range(14)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [undelta(*grow[0])]
        before = dmod.workspaces()[(0, side.cuda_stream)][1]
        outs += [undelta(x, i) for x, i in grow[1:] for _ in range(3)]
        after = dmod.workspaces()[(0, side.cuda_stream)][1]
    calls = [grow[0]] + [c for c in grow[1:] for _ in range(3)]
    for j, (got, (x, i)) in enumerate(zip(outs, calls)):
        _scan_equal(torch, ref, "undelta", got, x, i, f"back-to-back call {j}")
        checked += 1
    assert after > before, (before, after)

    # eight threads launching undelta on one stream at once, as the
    # checkpoint's restore does
    cases = [(rand((k + 1) * (1 << 20) + k), (8, 4, 2, 1)[k % 4]) for k in range(8)]
    results, streams = [None] * 8, set()
    start = threading.Barrier(8)

    def restore_like(k):
        x, itemsize = cases[k]
        streams.add(torch.cuda.current_stream().cuda_stream)
        start.wait()
        results[k] = [undelta(x, itemsize) for _ in range(25)]

    threads = [threading.Thread(target=restore_like, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(streams) == 1, streams
    for (x, itemsize), outs in zip(cases, results):
        for got in outs:
            _scan_equal(torch, ref, "undelta", got, x, itemsize, "8 threads, 1 stream")
            checked += 1

    # two streams launching at once: each has its own workspace
    pair = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [rand(32 << 20), rand((32 << 20) + 3)]
    torch.cuda.synchronize()
    outs2 = [None, None]
    start2 = threading.Barrier(2)

    def on_stream(k):
        with torch.cuda.stream(pair[k]):
            start2.wait()
            outs2[k] = [undelta(inputs[k], 8) for _ in range(20)]
        pair[k].synchronize()

    threads = [threading.Thread(target=on_stream, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for x, outs in zip(inputs, outs2):
        for got in outs:
            _scan_equal(torch, ref, "undelta", got, x, 8, "2 streams at once")
            checked += 1
    ws = dmod.workspaces()
    own = [ws[(0, s.cuda_stream)][0] for s in pair]
    assert own[0] != own[1], "two streams share a workspace"

    # one device operation a call, and nothing allocated but the output
    # (nothing at all with out=); the profiler may drop an event, never add one
    x, out = rand(1 << 20), torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
    _one_op(torch, lambda: undelta(x, 8, out=out), "undelta")
    stat = "allocation.all.allocated"
    n0 = torch.cuda.memory_stats()[stat]
    for _ in range(10):
        undelta(x, 8, out=out)
    n1 = torch.cuda.memory_stats()[stat]
    for _ in range(10):
        undelta(x, 8)
    n2 = torch.cuda.memory_stats()[stat]
    assert (n1 - n0, n2 - n1) == (0, 10), (n1 - n0, n2 - n1)
    log(f"phase 1: {checked} delta, zigzag, unzigzag and undelta runs byte-equal "
        "to the plain versions beyond the table above (itemsizes 1/2/4/8; the "
        "maps at 0, 1, 15, 16, 17, 256 and 269 313 vectors -/+ an element with "
        "every tail 1..I-1, zigzag's round trip, the signed extremes; undelta "
        "at n = 0, a tail alone, one tile, one "
        "tile -/+ an element, 7 tiles, the wrap; all four at pointers I bytes "
        f"off a 16-byte boundary; {len(calls)} back-to-back calls of growing size "
        f"on one stream, its workspace grown from {before} to {after} tiles; 8 "
        "threads on one stream; 2 streams at once with their own workspaces); one device "
        "operation a call, no allocation with out=, one without")
    for t in targets:
        log(f"phase 1: target {t}")
    return large


def _small_calls(torch, K):
    """name -> (kernel call, one-call PyTorch yardstick or None) at each
    kernel's small main-path shape: a 1 MiB basket for the preconditioners,
    the decode step's (4, 2048) for the quantizer."""
    g = torch.Generator(device="cuda").manual_seed(4)
    calls = {}
    for name, (itemsize, _) in MAIN_SHAPES.items():
        x = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device="cuda",
                          generator=g)
        args = _inputs(name, x, itemsize, K)
        calls[name] = ((lambda f=K[name], a=args: f(*a)),
                       _library_call(name, x, itemsize))
    # the bit shuffles at the lm_head row, and at 1 MiB with a tail
    for label, nbytes in (("lm_head", LM_HEAD_ROW), ("+tail", (1 << 20) + 3)):
        x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                          generator=g)
        for name in ("bitshuffle", "bitunshuffle"):
            args = _inputs(name, x, 4, K)
            calls[f"{name} {label}"] = ((lambda f=K[name], a=args: f(*a)), None)
    # the one-pass maps with a tail
    x = torch.randint(0, 256, ((1 << 20) + 3,), dtype=torch.uint8, device="cuda",
                      generator=g)
    for name in ("delta", "zigzag", "unzigzag"):
        itemsize = MAIN_SHAPES[name][0]
        calls[f"{name} +tail"] = ((lambda f=K[name], a=x, i=itemsize: f(a, i)), None)
    # the byte shuffles at the lm_head basket, and with a tail (the
    # yardstick transposes the elements alone)
    for label, nbytes in (("main", LM_HEAD_BASKET), ("+tail", LM_HEAD_BASKET + 1)):
        x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                          generator=g)
        for name in ("byteshuffle", "byteunshuffle"):
            calls[f"{name} {label}"] = ((lambda f=K[name], a=x: f(a, 2)),
                                        _library_call(name, x, 2))
    x = torch.randn(_serve_rows()[1], generator=g, device="cuda")
    q, s = K["qpack"](x, 1.0)
    qk, sk = q[None], s[None]
    calls["qpack"] = ((lambda: K["qpack"](x, 1.0)), None)
    calls["qunpack"] = ((lambda: K["qunpack"](qk, sk, torch.bfloat16)),
                        (lambda: torch.mul(q, s)))
    return calls


def phase_launch_split(torch, K):
    """Every kernel at its small shape: host microseconds per call (no
    sync), device microseconds and device operations per call (profiler),
    and the same for its one-call PyTorch yardstick."""
    split = {}
    log("kernel               host_us  device_us  ops/call   library host_us  device_us")
    for name, (kern, lib) in _small_calls(torch, K).items():
        h = host_us(kern)
        d, ops_per_call, names = device_ops_best(kern)
        row = {"host_us": h, "device_us": d, "device_ops_per_call": ops_per_call}
        txt = "-"
        if lib is not None:
            lh = host_us(lib)
            ld, lops, _ = device_ops(lib)
            row.update(library_host_us=lh, library_device_us=ld,
                       library_device_ops_per_call=lops)
            txt = f"{lh:8.2f}  {ld:8.2f} ({lops:g} ops)"
        split[name] = row
        log(f"{name:19s} {h:8.2f}  {d:9.2f}  {ops_per_call:8g}   {txt}")
        kernel = name.split()[0]
        if kernel in ("undelta", "qunpack"):
            assert ops_per_call == 1 and len(names) == 1, (name, names)
        if kernel == "qpack":
            # the kernel and nothing else; the profiler may drop an event
            assert len(names) == 1 and "qpack_kernel<" in next(iter(names)) \
                and 0.9 <= ops_per_call <= 1, (name, names)
        if kernel in ("bitshuffle", "bitunshuffle", "byteshuffle", "byteunshuffle",
                      "delta", "zigzag", "unzigzag"):
            # the kernel and nothing else (a memcpy would be a second name, a
            # second launch two a call); the profiler may drop an event
            assert len(names) == 1 and re.search(rf"\b{kernel}_kernel<",
                                                 next(iter(names))) \
                and 0.9 <= ops_per_call <= 1, (name, names)
    # the small-shape targets, on each side of the call: the host's time to
    # issue it and the device's time to run it
    for name, what in (("undelta", "1 MiB, torch.cumsum"),
                       ("qunpack", "(4, 2048), torch.mul")):
        r = split[name]
        for side in ("host", "device"):
            us, lib_us = r[f"{side}_us"], r[f"library_{side}_us"]
            log(f"phase 1: target {name} {what}, {side} us a call: {us:.2f} vs "
                f"{lib_us:.2f}: {'met' if us <= lib_us else 'missed'}")
    split["qunpack"]["host_split_us"] = qunpack_host_split(torch, K)
    split["qpack"]["host_split_us"] = qpack_host_split(torch, K)
    return split


BIT_LARGE_MS = 0.200              # 201 MB, I = 4: 60 % of the bound's rate
BIT_DEVICE_US = {"bitshuffle": 4.0, "bitunshuffle": 3.60}   # a call at 1 MiB


def bitshuffle_targets(rows, split):
    """The redesigned bit shuffles against their targets: events at 201 MB,
    device µs a call at 1 MiB and at the lm_head row, and host µs a call at
    1 MiB beside the other preconditioners' in the same run."""
    others = [split[k]["host_us"] for k in
              ("byteshuffle", "byteunshuffle", "delta", "undelta")]
    for row in rows:
        name = row["name"]
        if name not in BIT_DEVICE_US:
            continue
        ms = row["ms"]
        log(f"phase 1: target {name} {row['bytes']} B, I = 4: {ms:.4f} ms vs "
            f"{BIT_LARGE_MS} ms ({100 * row['bound_ms'] / ms:.0f} % of the "
            f"{row['bound_ms']:.4f} ms bound; d2d copy {row['d2d_copy_ms']:.4f} "
            f"ms): {'met' if ms <= BIT_LARGE_MS else 'missed'}")
        shapes = [("1 MiB", split[name])]
        if name == "bitshuffle":
            shapes.append((f"{LM_HEAD_ROW} B", split[f"{name} lm_head"]))
        for label, r in shapes:
            us, limit = r["device_us"], BIT_DEVICE_US[name]
            log(f"phase 1: target {name} {label}, device us a call: {us:.2f} vs "
                f"{limit}: {'met' if us <= limit else 'missed'}")
        us = split[name]["host_us"]
        log(f"phase 1: target {name} 1 MiB, host us a call: {us:.2f} within the "
            f"other preconditioners' [{min(others):.2f}, {max(others):.2f}]: "
            f"{'met' if us <= max(others) else 'missed'}")


BYTE_LARGE_MS = 0.075             # 100.66 MB, I = 2: 80 % of the bound's rate
BYTE_DEVICE_US = 2.31             # a call at the lm_head basket: PR 14's kernel


def byteshuffle_targets(rows, split, large):
    """The redesigned byte shuffles against their targets: events at
    100.66 MB, device µs a call at the lm_head basket, and events, host and
    device µs there against ``view().t().contiguous()`` in the same run."""
    for row in rows:
        name = row["name"]
        if name not in ("byteshuffle", "byteunshuffle"):
            continue
        ms = row["ms"]
        log(f"phase 1: target {name} {row['bytes']} B, I = 2: {ms:.4f} ms vs "
            f"{BYTE_LARGE_MS} ms ({100 * row['bound_ms'] / ms:.0f} % of the "
            f"{row['bound_ms']:.4f} ms bound; d2d copy {row['d2d_copy_ms']:.4f} "
            f"ms): {'met' if ms <= BYTE_LARGE_MS else 'missed'}")
        for itemsize, r in large[name].items():
            log(f"phase 1: {name} 100 MB, I = {itemsize}: {r['ms']:.4f} ms "
                f"({100 * r['bound_ms'] / r['ms']:.0f} % of the bound; d2d copy "
                f"{r['d2d_copy_ms']:.4f} ms, view().t().contiguous() "
                f"{r['library_ms']:.4f} ms)")
        r = split[f"{name} main"]
        us = r["device_us"]
        log(f"phase 1: target {name} {LM_HEAD_BASKET} B, device us a call: "
            f"{us:.2f} vs {BYTE_DEVICE_US}: {'met' if us <= BYTE_DEVICE_US else 'missed'}")
        for clock, mine, lib, fmt in (
                ("events ms", row["basket_ms"], row["basket_library_ms"], ".4f"),
                ("host us", r["host_us"], r["library_host_us"], ".2f"),
                ("device us", us, r["library_device_us"], ".2f")):
            log(f"phase 1: target {name} {LM_HEAD_BASKET} B, {clock} a call: "
                f"{mine:{fmt}} vs view().t().contiguous() {lib:{fmt}}: "
                f"{'met' if mine <= lib else 'missed'}")


def _host_split(what: str, pieces: dict, calls: int = 2000, rounds: int = 5) -> dict:
    """Host microseconds a call of each of ``pieces``: medians over
    ``rounds`` taken in turns."""
    per = {k: [] for k in pieces}
    for _ in range(rounds):
        for name, f in pieces.items():
            per[name].append(host_us(f, calls, 1))
    split = {k: sorted(v)[rounds // 2] for k, v in per.items()}
    log(f"phase 1: {what} host us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()))
    return split


def qunpack_host_split(torch, K) -> dict:
    """Host microseconds a call of the pieces of qunpack's decode-shape call
    beside ``torch.mul(q, s)``: the whole wrapper, its output allocation,
    the shared launch path (``_build.call``) and the launcher alone through
    ctypes, each with fixed pointers."""
    from repro_torch.kernels import _build
    x = torch.randn(_serve_rows()[1], generator=torch.Generator(device="cuda")
                    .manual_seed(5), device="cuda")
    q, s = K["qpack"](x, 1.0)
    qk, sk = q[None], s[None]
    out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
    args = (qk.data_ptr(), sk.data_ptr(), out.data_ptr(), 1, *q.shape, 1)
    fn, stream = _build._fns["rt_qunpack"], _build.current_stream(0)
    return _host_split("qunpack (4, 2048)", {
        "wrapper": lambda: K["qunpack"](qk, sk, torch.bfloat16),
        "torch.mul(q, s)": lambda: torch.mul(q, s),
        "output allocation": lambda: q.new_empty(q.shape, dtype=torch.bfloat16),
        "_build.call": lambda: _build.call(None, "rt_qunpack", 0, *args,
                                           counted=False),
        "launcher via ctypes": lambda: fn(*args, stream),
    })


def qpack_host_split(torch, K) -> dict:
    """The same for qpack's decode-shape call: the whole wrapper beside
    qunpack's, its two output allocations, ``_build.call`` and the launcher
    alone through ctypes."""
    from repro_torch.kernels import _build
    x = torch.randn(_serve_rows()[1], generator=torch.Generator(device="cuda")
                    .manual_seed(9), device="cuda")
    q, s = K["qpack"](x, 1.0)
    qk, sk = q[None], s[None]
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), *x.shape, 0, 1.0)
    fn, stream = _build._fns["rt_qpack"], _build.current_stream(0)
    return _host_split("qpack (4, 2048)", {
        "wrapper": lambda: K["qpack"](x, 1.0),
        "qunpack wrapper": lambda: K["qunpack"](qk, sk, torch.bfloat16),
        "output allocations": lambda: (x.new_empty(x.shape, dtype=torch.int8),
                                       x.new_empty((x.shape[0], 1), dtype=torch.float32)),
        "_build.call": lambda: _build.call(None, "rt_qpack", 0, *args, counted=False),
        "launcher via ctypes": lambda: fn(*args, stream),
    })


def qpack_targets(rows, split, large):
    """The redesigned qpack against its targets: events at (32768, 2048)
    f32, and bf16 beside its bound; device µs and operations a call at the
    decode shape; host µs there against qunpack's in the same run; events
    at the prefill shape."""
    row = next(r for r in rows if r["name"] == "qpack")
    ms, bound = row["ms"], row["bound_ms"]
    log(f"phase 1: target qpack 32768x{SERVE_D_MODEL} f32, events: {ms:.4f} ms vs "
        f"{QPACK_LARGE_MS} ms ({100 * bound / ms:.0f} % of the {bound:.4f} ms bound; "
        f"phase_qpack's run {large['float32']['ms']:.4f} ms): "
        f"{'met' if ms <= QPACK_LARGE_MS else 'missed'}")
    b = large["bfloat16"]
    log(f"phase 1: qpack 32768x{SERVE_D_MODEL} bf16, events: {b['ms']:.4f} ms "
        f"({100 * b['bound_ms'] / b['ms']:.0f} % of the {b['bound_ms']:.4f} ms bound)")
    r, u = split["qpack"], split["qunpack"]
    log(f"phase 1: target qpack (4, 2048) f32, device us a call: {r['device_us']:.2f} vs "
        f"{QPACK_DEVICE_US}: {'met' if r['device_us'] <= QPACK_DEVICE_US else 'missed'}")
    log(f"phase 1: target qpack (4, 2048) f32, device operations a call: "
        f"{r['device_ops_per_call']:g} (asserted): met")
    log(f"phase 1: target qpack (4, 2048) f32, host us a call: {r['host_us']:.2f} vs "
        f"qunpack's {u['host_us']:.2f}: {'met' if r['host_us'] <= u['host_us'] else 'missed'}")
    hs = r["host_split_us"]
    log(f"phase 1: target qpack (4, 2048) f32, host us a call, wrappers in turns: "
        f"{hs['wrapper']:.2f} vs qunpack's {hs['qunpack wrapper']:.2f}: "
        f"{'met' if hs['wrapper'] <= hs['qunpack wrapper'] else 'missed'}")
    log(f"phase 1: qpack (256, 2048) f32, events: {row['prefill_ms']:.4f} ms "
        f"(bound {row['prefill_bound_ms']:.4f} ms)")


# ---------------------------------------------------------------------------
# phase 2: golden checkpoint from CUDA tensors
# ---------------------------------------------------------------------------

def phase_golden(torch, np, tmp):
    from repro_torch.checkpoint import save_pytree, tree_from_numpy
    from repro_torch.core.bfile import BasketFile
    from repro_torch.core.codec import HAVE_ZSTD
    golden_dir = os.path.join(ROOT, "tests", "golden")
    man = json.load(open(os.path.join(golden_dir, "container_manifest.json")))
    golden = open(os.path.join(golden_dir, "ckpt_pr2.bskt"), "rb").read()
    rng = np.random.default_rng(42)
    rng.standard_normal(40_000)           # the stream as the golden's generator
    rng.integers(1, 9, 30_000)
    rng.integers(0, 255, 50_000)
    host = {"w": rng.standard_normal((300, 257)).astype(np.float32),
            "emb": {"table": rng.integers(0, 1 << 20, 70_000).astype(np.int64)},
            "step": np.int64(123)}
    tree = tree_from_numpy(host, "cuda")
    with BasketFile(os.path.join(golden_dir, "ckpt_pr2.bskt")) as f:
        meta_at = f.branches["__meta__"]["baskets"][0]["offset"]
    for staging in ("gather", "stream"):
        for workers in (0, 4):
            p = os.path.join(tmp, f"golden-{staging}{workers}.bskt")
            save_pytree(p, tree, profile="analysis", workers=workers,
                        staging=staging)
            blob = open(p, "rb").read()
            sha = hashlib.sha256(blob).hexdigest()
            if HAVE_ZSTD:
                # the __meta__ blob takes the default codec (zstd here); the
                # data baskets before it must still be the golden's
                assert blob[:meta_at] == golden[:meta_at], (staging, workers)
                note = "data baskets equal (zstandard installed: __meta__ differs)"
            else:
                assert sha == man["ckpt_pr2.bskt"], (staging, workers, sha)
                note = "sha256 equal"
            log(f"phase 2: golden ckpt_pr2 staging={staging} workers={workers}: "
                f"{sha[:16]}... {note}")


# ---------------------------------------------------------------------------
# phase 3: the paper's event tree
# ---------------------------------------------------------------------------

def phase_events(torch, np, tmp, workers):
    from repro_torch.checkpoint import load_pytree, save_pytree, tree_from_numpy
    from repro_torch.data import make_events
    t0 = time.perf_counter()
    host = make_events(2_000_000, seed=0)
    gpu = tree_from_numpy(host, "cuda")
    cpu = tree_from_numpy(host, "cpu")
    nbytes = sum(v.nbytes for v in host.values())
    log(f"phase 3: events 2M: {len(host['Jet_pt'])} jets, {nbytes / 1e9:.3f} GB "
        f"(made in {time.perf_counter() - t0:.1f} s)")
    pg, pc = os.path.join(tmp, "events-gpu.bskt"), os.path.join(tmp, "events-cpu.bskt")
    torch.cuda.synchronize()
    stage_seconds()
    t0 = time.perf_counter()
    stats = save_pytree(pg, gpu, workers=workers)
    save_s = time.perf_counter() - t0
    log(f"phase 3: save stages (s): {stage_seconds()}")
    t0 = time.perf_counter()
    save_pytree(pc, cpu, workers=workers)
    cpu_save_s = time.perf_counter() - t0
    same = open(pg, "rb").read() == open(pc, "rb").read()
    assert same, "event tree: bytes from CUDA tensors differ from CPU tensors'"
    stage_seconds()
    t0 = time.perf_counter()
    flat, _ = load_pytree(pg, device="cuda", workers=workers)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"phase 3: restore stages (s): {stage_seconds()}")
    for k, v in gpu.items():
        assert same_bits(flat[k], v), k
    log(f"phase 3: save from CUDA {save_s:.3f} s, from CPU tensors {cpu_save_s:.3f} s, "
        f"bytes equal; restore to CUDA {load_s:.3f} s bitwise; ratio "
        f"{stats['raw'] / stats['comp']:.3f}")
    return {"gb": nbytes / 1e9, "save_s": save_s, "cpu_tensor_save_s": cpu_save_s,
            "restore_s": load_s, "ratio": stats["raw"] / stats["comp"]}, host, pg


# ---------------------------------------------------------------------------
# phase 3b: a tuned zigzag save and restore on the card
# ---------------------------------------------------------------------------

ZIGZAG_CANDIDATES = [("zlib", 1, "zigzag4")]


def phase_zigzag_save(torch, np, tmp, host, workers):
    """A save and restore through the zigzag kernels: ``Tuner("min_bytes",
    candidates=ZIGZAG_CANDIDATES)`` on a signed int32 tensor (16 MiB of
    small magnitudes of both signs) and on the event tree's ``Muon_charge``
    branch, saved from CUDA tensors, then from CPU tensors with the same
    tuner (its decisions reused, so the two files must be byte-equal), and
    restored to the card bitwise."""
    from repro_torch.checkpoint import load_pytree, save_pytree, tree_from_numpy
    from repro_torch.tune import Tuner, load_decisions
    rng = np.random.default_rng(25)
    tree = {"ids": rng.integers(-50_000, 50_000, 4 << 20).astype(np.int32),
            "Muon_charge": host["Muon_charge"]}
    assert tree["Muon_charge"].dtype == np.int32 and tree["Muon_charge"].min() < 0
    gpu, cpu = tree_from_numpy(tree, "cuda"), tree_from_numpy(tree, "cpu")
    tuner = Tuner("min_bytes", candidates=ZIGZAG_CANDIDATES)
    pg = os.path.join(tmp, "zigzag-gpu.bskt")
    pc = os.path.join(tmp, "zigzag-cpu.bskt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = save_pytree(pg, gpu, workers=workers, tuner=tuner)
    save_s = time.perf_counter() - t0
    save_pytree(pc, cpu, workers=workers, tuner=tuner)
    assert tuner.stats["reused"] == len(tree), tuner.stats
    decisions = {k: d["precond"] for k, d in load_decisions(pg).items()}
    assert decisions == dict.fromkeys(tree, "zigzag4"), decisions
    assert open(pg, "rb").read() == open(pc, "rb").read(), \
        "tuned zigzag4: bytes from CUDA tensors differ from CPU tensors'"
    t0 = time.perf_counter()
    flat, _ = load_pytree(pg, device="cuda", workers=workers)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for k, v in gpu.items():
        assert same_bits(flat[k], v), k
    ratio = stats["raw"] / stats["comp"]
    log(f"phase 3b: tuned zigzag4 save of {stats['raw'] / 1e6:.1f} MB (a signed "
        f"int32 tensor and Muon_charge) from CUDA {save_s:.3f} s, bytes equal to "
        f"the CPU tensors' save; restore to CUDA {load_s:.3f} s bitwise; ratio "
        f"{ratio:.3f}; decisions {decisions}")
    return {"mb": stats["raw"] / 1e6, "save_s": save_s, "restore_s": load_s,
            "ratio": ratio, "decisions": decisions}


# ---------------------------------------------------------------------------
# processes: this script's children, and what multiprocessing starts
# ---------------------------------------------------------------------------

def _proc_table() -> dict:
    """{pid: {"ppid", "pgrp", "state"}} of every process, from /proc."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
        except OSError:                    # ended while the table was read
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[int(name)] = {"state": fields[0], "ppid": int(fields[1]),
                          "pgrp": int(fields[2])}
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def _live_processes(pick, wait_s: float = 10.0) -> list:
    """[(pid, cmdline)] of the processes ``pick(table)`` names that are
    still alive (zombies are not) after waiting up to ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while True:
        table = _proc_table()
        left = sorted(pid for pid in pick(table) if table[pid]["state"] not in "ZX")
        if not left or time.monotonic() >= deadline:
            return [(pid, _cmdline(pid)) for pid in left]
        time.sleep(0.2)


def _descendants(table: dict, root: int) -> set:
    kids: dict = {}
    for pid, st in table.items():
        kids.setdefault(st["ppid"], []).append(pid)
    out, todo = set(), [root]
    while todo:
        for k in kids.get(todo.pop(), []):
            if k not in out:
                out.add(k)
                todo.append(k)
    return out


def live_descendants(wait_s: float = 10.0) -> list:
    """[(pid, cmdline)] of this process's descendants still alive after
    waiting up to ``wait_s``."""
    me = os.getpid()
    return _live_processes(lambda table: _descendants(table, me), wait_s)


def stop_multiprocessing_helpers() -> None:
    """Stop multiprocessing's forkserver and resource tracker, if this
    process started them (the I/O engine's process pool and its
    shared-memory slabs do); each waits for its process to end."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


# ---------------------------------------------------------------------------
# phase 4: qwen3-8b train state, full width, depth 1
# ---------------------------------------------------------------------------

D, H, KV, DH, FF, VOCAB = 4096, 32, 8, 128, 12288, 151936


def qwen3_8b_depth1_specs():
    """The port's Model.param_specs() for qwen3-8b with n_groups = 1 (layer
    leaves stacked on a leading "layers" axis), checked against the widths
    of the published config: {dotted path: ParamSpec}."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.specs import tree_paths
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=1)
    specs = tree_paths(Model(cfg).param_specs())
    attn = {"wq": (1, D, H, DH), "wk": (1, D, KV, DH), "wv": (1, D, KV, DH),
            "wo": (1, H, DH, D), "q_norm": (1, DH), "k_norm": (1, DH)}
    want = {"embed": (VOCAB, D), "lm_head": (D, VOCAB), "final_norm.scale": (D,),
            "layers.l0.ln1.scale": (1, D), "layers.l0.ln2.scale": (1, D),
            "layers.l0.ffn.w_gate": (1, D, FF), "layers.l0.ffn.w_up": (1, D, FF),
            "layers.l0.ffn.w_down": (1, FF, D),
            **{f"layers.l0.attn.{k}": v for k, v in attn.items()}}
    got = {path: tuple(spec.shape) for path, spec in specs.items()}
    assert got == want, got
    return cfg, specs


def run_depth1(torch, model, params):
    """A prefill of 2 x 64 tokens and 3 greedy decode steps of the depth-1
    model on ``params`` cast to bf16: the logits of each call."""
    p = _to(torch, params, torch.bfloat16)
    tokens = torch.randint(2, model.cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        logits, cache = model.prefill(p, {"tokens": tokens.to(p["embed"].device)}, 128)
        out = [logits]
        for i in range(3):
            logits, cache = model.decode_step(p, cache, logits.argmax(-1)[:, None], 64 + i)
            out.append(logits)
    torch.cuda.synchronize()
    return out


def disk_write_gbps(tmp: str, nbytes: int = 1 << 30) -> float:
    """Write + fsync rate of the checkpoint directory's disk."""
    block = os.urandom(1 << 24)
    path = os.path.join(tmp, "disk-probe")
    t0 = time.perf_counter()
    with open(path, "wb") as fh:
        for _ in range(nbytes // len(block)):
            fh.write(block)
        fh.flush()
        os.fsync(fh.fileno())
    dt = time.perf_counter() - t0
    os.remove(path)
    return nbytes / dt / 1e9


# the trainer's run: the driver's defaults (batch 8 x 128), compressed
# gradients (a bf16 residual: shuffle2, as bf16 moments were), 4 steps,
# one save at step 4
TRAIN_ARGS = ["--arch", "qwen3-8b", "--steps", "4", "--ckpt-every", "4",
              "--log-every", "1", "--compress-grads"]
# the preemption drill, as a user would run it (reduced qwen3-8b on the card)
DRILL_ARGS = ["--arch", "qwen3-8b", "--reduced", "--steps", "6",
              "--ckpt-every", "3"]
# resumed against uninterrupted, step 6: bf16 compute, and the embedding's
# backward accumulates with atomics in no fixed order, so bits may differ
DRILL_RTOL = 1e-3


def _step_flops_bytes(cfg, n_params: int, tokens: int) -> dict:
    """The least work of one train step: the float32 unembedding's GEMMs
    (forward and two backward) at the float32 peak, the layer's bf16 GEMMs
    likewise at the bf16 peak, and the optimizer's bytes (read p, g, m, v
    in float32 and the bf16 residual; write p, m, v and the residual) at
    the HBM rate.  Attention's score GEMMs are left out (S = 128)."""
    unembed = 6 * cfg.d_model * cfg.vocab * tokens
    layer_params = n_params - 2 * cfg.d_model * cfg.vocab
    layer = 6 * layer_params * tokens
    opt_bytes = n_params * (4 * 4 + 2 + 3 * 4 + 2)
    ms = {"unembed_f32": unembed / F32_FLOPS * 1e3,
          "layer_bf16": layer / BF16_FLOPS * 1e3,
          "optimizer_bytes": opt_bytes / HBM_BYTES_PER_S * 1e3}
    return {"unembed_tflop": unembed / 1e12, "layer_tflop": layer / 1e12,
            "optimizer_gb": opt_bytes / 1e9, "bound_ms": ms,
            "bound_ms_total": sum(ms.values())}


def _kind(name: str) -> str:
    n = name.lower()
    for kind, keys in (("gemm", ("gemm", "xmma", "nvjet", "cutlass")),
                       ("reduce", ("reduce",)), ("index", ("index", "scatter", "gather")),
                       ("elementwise", ("elementwise", "unrolled", "vectorized")),
                       ("copy/fill", ("memcpy", "memset", "fill", "copy"))):
        if any(k in n for k in keys):
            return kind
    return "other"


def _profile_step(torch, step_fn, state, batch):
    """One train step under torch.profiler: wall, device busy time (every
    device operation, summed), that time by kind of operation, and the
    entries that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del new
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    by_kind: dict = {}
    for e in evs:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in evs), "by_kind_ms": by_kind,
            "top_device_ms": [(e.key[:100], e.count, e.self_device_time_total / 1e3)
                              for e in top]}


def _step_phases(torch, model, state, batch):
    """Device ms of the train step's parts, each between CUDA events, on
    the live state: forward and backward through the bf16 cast, the int8
    error-feedback quantizer over every leaf, the clip, AdamW."""
    from repro_torch.train import adamw_update, clip_by_global_norm
    from repro_torch.train.optim import tree_leaves, tree_map, tree_unflatten
    from repro_torch.train.step import _quantize_ef
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    leaves = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    flat = tree_leaves(leaves)
    ev[0].record()
    loss, _ = model.loss(tree_map(lambda p: p.to(torch.bfloat16), leaves), batch)
    grads = torch.autograd.grad(loss, flat)
    ev[1].record()
    with torch.no_grad():
        pairs = [_quantize_ef(g, e) for g, e in zip(grads, tree_leaves(state.err))]
        del grads
        deq = tree_unflatten(state.params, [p[0] for p in pairs])
        del pairs
        ev[2].record()
        clipped, _ = clip_by_global_norm(deq, 1.0)
        del deq
        ev[3].record()
        out = adamw_update(clipped, state.opt, state.params, 1e-4)
        ev[4].record()
    torch.cuda.synchronize()
    del out, clipped, leaves, flat
    names = ["forward_backward", "quantize_ef", "clip", "adamw"]
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def _configs(path: str) -> dict:
    """{"algo-level precond": [branches, raw bytes, stored bytes]} of a
    saved checkpoint, from its TOC."""
    from repro_torch.core.bfile import BasketFile
    out: dict = {}
    with BasketFile(path) as f:
        for name, entry in f.branches.items():
            if name == "__meta__":
                continue
            c = entry["config"]
            row = out.setdefault(f"{c['algo']}-{c['level']} {c['precond']}", [0, 0, 0])
            row[0] += 1
            row[1] += sum(b["meta"]["orig_len"] for b in entry["baskets"])
            row[2] += sum(b["meta"]["comp_len"] for b in entry["baskets"])
    return out


def phase_train(torch, np, tmp, ops, cfg, device="cuda"):
    """``cfg`` (qwen3-8b at full width, depth 1) trained for 4 steps by
    ``repro_torch.launch.train`` with compressed gradients; its step-4
    checkpoint restored through CheckpointManager bitwise against the live
    state; the depth-1 model on the restored weights bit-equal to the live
    weights'; one profiled step, and one under ``FlopCounterMode``.  The
    checkpoint and the shards stay in ``workdir`` for phases 4c and 4e."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.launch import train as launch
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    args = launch.parse_args(TRAIN_ARGS + ["--workdir", os.path.join(tmp, "train"),
                                           "--device", device])
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    stage_seconds()
    t0 = time.perf_counter()
    run = launch.run(cfg, model, args)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    save_stages = stage_seconds()
    assert run.code == 0 and run.save_stats is not None
    save_counts = ops.launch_counts()
    tree = {"params": run.state.params, "opt": run.state.opt,
            "step": run.state.step, "err": run.state.err}
    flat = _flatten_with_paths(tree)
    n_params = sum(t.numel() for k, t in flat.items() if k.startswith("params."))
    nbytes = sum(t.numel() * t.element_size() for t in flat.values() if t is not None)
    with open(os.path.join(args.workdir, "train_log.jsonl")) as fh:
        log_lines = [json.loads(line) for line in fh]
    losses = [m["loss"] for m in log_lines]
    assert [m["step"] for m in log_lines] == [1, 2, 3, 4], log_lines
    assert all(np.isfinite(v) for v in losses), losses
    assert int(run.state.step) == 4 and run.state.err is not None
    step_ms = sorted(run.step_seconds[1:4])[1] * 1e3
    tokens = args.batch * args.seq_len
    bound = _step_flops_bytes(cfg, n_params, tokens)
    log(f"phase 4: qwen3-8b depth 1 trained by launch.train: {n_params / 1e9:.3f} B "
        f"params, state {nbytes / 1e9:.2f} GB (f32 params and moments, bf16 "
        f"residual); losses {losses}; step {step_ms:.1f} ms (median of steps "
        f"2-4; all: {[round(x * 1e3, 1) for x in run.step_seconds]}), "
        f"{tokens / step_ms * 1e3:.0f} tok/s; bound {bound['bound_ms_total']:.1f} ms "
        f"{bound['bound_ms']}; peak device memory {peak_gb:.2f} GB; run wall "
        f"{wall_s:.1f} s")
    stats = run.save_stats
    save_s = stats["wall_s"]
    ckpt = os.path.join(args.workdir, "ckpt", "ckpt-00000004.bskt")
    configs = _configs(ckpt)
    log(f"phase 4: save stages (s): {save_stages}; configs [branches, raw bytes, "
        f"stored bytes]: {configs}; launches on the save: {save_counts}")
    # one more step on the live state under the profiler (its result dropped)
    step_fn = make_train_step(model, peak_lr=args.lr, warmup=5, total_steps=4,
                              compress_grads=True)
    rng = np.random.default_rng(3)
    tok = rng.integers(2, cfg.vocab, (args.batch, args.seq_len + 1)).astype(np.int32)
    batch = launch.build_batch(cfg, {"tokens": tok[:, :-1], "targets": tok[:, 1:]},
                               1, device)
    prof = _profile_step(torch, step_fn, run.state, batch)
    log(f"phase 4: one profiled step: {prof}")
    prof["phases_ms"] = _step_phases(torch, model, run.state, batch)
    log(f"phase 4: the step's parts, device ms between events: {prof['phases_ms']}")
    # the dot FLOPs of one real step, for phase 10's (1, 1) cell
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flops:
        new, _ = step_fn(run.state, batch)
    del new
    step_flops = flops.get_total_flops()
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    restored, meta = CheckpointManager(os.path.join(args.workdir, "ckpt")).restore(
        device=device, template=tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_stages = stage_seconds()
    restore_counts = ops.launch_counts()
    log(f"phase 4: restore stages (s): {restore_stages}; launches on the "
        f"restore: {restore_counts}; cursor {meta['data_cursor']}")
    back = _flatten_with_paths(restored)
    for k, t in flat.items():
        assert (back[k] is None) if t is None else same_bits(back[k], t), k
    # the restored weights run the model as the saved ones do, bit for bit
    before = run_depth1(torch, model, run.state.params)
    after = run_depth1(torch, model, restored["params"])
    for i, (a, b) in enumerate(zip(before, after)):
        assert a.shape == (2, cfg.vocab) and torch.isfinite(a).all(), i
        assert same_bits(a, b), f"call {i}: logits of the restored weights differ"
    log("phase 4: the depth-1 model on the restored weights (bf16): prefill 2 x 64 "
        "and 3 decode steps, logits bit-equal to the live weights'")
    ratio = stats["raw"] / stats["comp"]
    wait_s = save_stages.get("ckpt.stage.wait_s", 0.0)
    log(f"phase 4: save {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s; waiting "
        f"for kernels and D2H {wait_s:.3f} s = {100 * wait_s / save_s:.2f}%), restore "
        f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s), bitwise equal; "
        f"ratio {ratio:.4f}")
    for name in ("bitshuffle", "byteshuffle"):
        assert save_counts[name] > 0, f"{name} not launched on the trainer's save"
    for name in ("bitunshuffle", "byteunshuffle"):
        assert restore_counts[name] > 0, f"{name} not launched on the restore"
    counts = {k: save_counts[k] + restore_counts[k] for k in save_counts}
    step_ms_all = [x * 1e3 for x in run.step_seconds]
    live = run.state
    del restored, back, run, tree, flat
    return {"gb": nbytes / 1e9, "nbytes": nbytes, "batch_bytes": batch_bytes,
            "step_flops": step_flops, "workdir": args.workdir,
            "n_params": n_params, "losses": losses,
            "step_ms": step_ms, "step_ms_all": step_ms_all,
            "tok_per_s": tokens / step_ms * 1e3, "bound": bound,
            "peak_gb": peak_gb, "profile": prof, "save_s": save_s,
            "restore_s": restore_s, "ratio": ratio, "configs": configs,
            "save_stages_s": save_stages, "restore_stages_s": restore_stages,
            "save_launches": save_counts, "restore_launches": restore_counts}, \
        counts, live


def phase_elastic_restore(torch, ops, cfg, live, static, device="cuda"):
    """Phase 4's checkpoint restored through ``CheckpointManager.restore(
    shardings=...)`` onto ``make_host_mesh()`` ((1, 1) on cuda:0) with the
    placements of ``param_shardings`` and ``opt_shardings`` under
    ``parallelism_for(cfg)``: every leaf a DTensor on that mesh, bitwise
    equal to the live state.  ``static`` holds phase 4's plain restore.
    Returns (summary, launch counts of the restore)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import parallelism_for
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import (NamedSharding, P, opt_shardings,
                                               param_shardings)
    mesh = make_host_mesh(device=device)
    model, pcfg = Model(cfg), parallelism_for(cfg)
    psh, osh = param_shardings(model, mesh, pcfg), opt_shardings(model, mesh, pcfg)
    rep = NamedSharding(mesh, P())
    shardings = {"params": psh, "opt": {"m": osh, "v": osh, "count": rep},
                 "step": rep, "err": psh}
    tree = {"params": live.params, "opt": live.opt, "step": live.step, "err": live.err}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, _ = CheckpointManager(os.path.join(static["workdir"], "ckpt")).restore(
        template=tree, shardings=shardings, device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want, got = _flatten_with_paths(tree), _flatten_with_paths(restored)
    flat_sh = _flatten_with_paths(shardings)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        if t is None:
            continue
        d = got[k]
        assert isinstance(d, DTensor) and d.device_mesh == mesh, k
        assert list(d.placements) == flat_sh[k].placements, k
        assert same_bits(d.to_local(), t), k
    for name in ("bitunshuffle", "byteunshuffle"):
        assert counts[name] > 0, f"{name} not launched on the elastic restore"
    n_leaves = sum(t is not None for t in want.values())
    log(f"phase 4c: elastic restore onto {mesh} ({n_leaves} leaves, every one a "
        f"DTensor on the rules' placements, bitwise equal to the live state): "
        f"{wall_s:.3f} s against phase 4's plain restore {static['restore_s']:.3f} s "
        f"in this call; launches: bitunshuffle {counts['bitunshuffle']}, "
        f"byteunshuffle {counts['byteunshuffle']}")
    del restored, got
    return {"wall_s": wall_s, "plain_restore_s": static["restore_s"],
            "leaves": n_leaves, "mesh": str(mesh), "launches": counts}, counts


# ---------------------------------------------------------------------------
# phase 4d: remat and the layers' variants on the trainer's live state
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "dots")
VARIANT_RTOL = 3e-2               # the CPU tests' bf16 bound (test_torch_dense.py)


def _train_batch(torch, np, cfg, seed: int):
    """A batch of the trainer's shape (8 x 128) on the card."""
    from repro_torch.launch import train as launch
    tok = np.random.default_rng(seed).integers(
        2, cfg.vocab, (8, 129)).astype(np.int32)
    return launch.build_batch(cfg, {"tokens": tok[:, :-1], "targets": tok[:, 1:]},
                              1, "cuda")


def _loss_grads(torch, model, params, batch):
    """The train step's loss and gradients: the float32 leaves cast to bf16
    for the model, the gradients through the cast."""
    from repro_torch.train.optim import tree_leaves, tree_map
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = tree_leaves(leaves)
    loss, _ = model.loss(tree_map(lambda p: p.to(torch.bfloat16), leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


def phase_remat(torch, np, cfg, live):
    """(a) The trainer's step on phase 4's live state with ``remat``
    "none", "full" and "dots": the loss and every gradient bitwise equal
    (deterministic algorithms on, so the embedding's backward sorts instead
    of adding with atomics), then whole train steps in turns, each mode's
    wall and peak memory.  (d) The layers' variants at full width: the
    depth-1 forward in bf16 with ``rms_einsum``, then
    ``softmax_bf16_probs``, against the default path."""
    import dataclasses
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.models import Model, layers
    from repro_torch.train import make_train_step
    batch = _train_batch(torch, np, cfg, 4)
    models = {r: Model(dataclasses.replace(cfg, remat=r)) for r in REMAT_MODES}
    names = list(_flatten_with_paths(live.params))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        base_loss, base = _loss_grads(torch, models["none"], live.params, batch)
        for r in ("full", "dots"):
            loss, grads = _loss_grads(torch, models[r], live.params, batch)
            assert same_bits(loss, base_loss), (r, loss.item(), base_loss.item())
            differ = [n for n, g, w in zip(names, grads, base) if not same_bits(g, w)]
            assert not differ, f"remat={r}: gradients differ from none's: {differ}"
            del grads
        del base
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"phase 4d: loss {base_loss.item():.6f} and all {len(names)} gradients "
        f"bitwise equal under remat none, full and dots")
    steps = {r: make_train_step(models[r], peak_lr=3e-4, warmup=5, total_steps=4,
                                compress_grads=True) for r in REMAT_MODES}
    wall = {r: [] for r in REMAT_MODES}
    peak = {}
    for rnd in range(3):                   # round 0 warms each mode up
        for r in REMAT_MODES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new, metrics = steps[r](live, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            if rnd:
                wall[r].append((time.perf_counter() - t0) * 1e3)
            if rnd == 1:
                peak[r] = torch.cuda.max_memory_allocated() / 1e9
            del new, metrics
    step_ms = {r: min(v) for r, v in wall.items()}
    log(f"phase 4d: train step ms by remat (best of 2, in turns): {step_ms} "
        f"(all: {wall}); peak device memory GB during the step: {peak}")
    p16 = _to(torch, live.params, torch.bfloat16)
    variants = {}
    with torch.no_grad():
        want, _ = models["none"].forward(p16, {"tokens": batch["tokens"]})
        for flag in ("rms_einsum", "softmax_bf16_probs"):
            layers.PERF_FLAGS[flag] = True
            try:
                got, _ = models["none"].forward(p16, {"tokens": batch["tokens"]})
            finally:
                layers.PERF_FLAGS[flag] = False
            rel = _rel(torch, got, want)
            assert torch.isfinite(got).all() and rel < VARIANT_RTOL, (flag, rel)
            variants[flag] = {"rel_err": rel, "bits_equal": same_bits(got, want)}
    log(f"phase 4d: the depth-1 forward in bf16 (8 x 128) with each variant "
        f"against the default path: {variants} (bound {VARIANT_RTOL})")
    del p16, want, got
    torch.cuda.empty_cache()
    return {"loss": base_loss.item(), "grads_bitwise": len(names),
            "step_ms": step_ms, "step_ms_all": wall, "peak_gb": peak,
            "variants": variants}


# ---------------------------------------------------------------------------
# phase 4e: token shards over repro://, and the prefetching restore
# ---------------------------------------------------------------------------

def _service_threads() -> list:
    """Live threads of the remote service: the server's, its request
    handlers', the client's fetchers and the scrubber's."""
    import threading
    return [t.name for t in threading.enumerate() if t.is_alive() and (
        t.name.startswith(("repro-bserve", "repro-remote", "repro-scrubber"))
        or "process_request" in t.name)]


def phase_remote(torch, np, ops, cfg, live, static):
    """Phase 4's token shards served by the port's ``BasketServer`` on
    loopback: three train steps on batches read through ``repro://`` URLs,
    each batch bitwise that of the local paths, the server closed in a
    ``finally`` and no service thread left.  Then phase 4's checkpoint
    restored with ``load_pytree(prefetch=4)`` (the codec stage of the next
    four baskets on the engine's threads), bitwise against the live state,
    its wall beside phase 4's ``prefetch=0`` restore.  Returns (summary,
    launch counts of the restore)."""
    import glob
    from repro_torch.checkpoint import load_pytree
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as launch
    from repro_torch.models import Model
    from repro_torch.remote import BasketServer
    from repro_torch.train import make_train_step
    data = os.path.join(static["workdir"], "data")
    shards = sorted(glob.glob(os.path.join(data, "*.bskt")))
    assert shards, data
    step_fn = make_train_step(Model(cfg), peak_lr=3e-4, warmup=5, total_steps=4,
                              compress_grads=True)
    losses = []
    srv = BasketServer(data, workers=2)
    try:
        srv.start()
        urls = [srv.url(os.path.basename(p)) for p in shards]
        remote = TokenPipeline(urls, batch=8, seq_len=128)
        local = TokenPipeline(shards, batch=8, seq_len=128)
        try:
            state = live
            for _ in range(3):
                br, bl = next(remote), next(local)
                assert sorted(br) == sorted(bl)
                for k in br:
                    assert br[k].dtype == bl[k].dtype and np.array_equal(br[k], bl[k]), k
                state, m = step_fn(state, launch.build_batch(cfg, br, 1, "cuda"))
                losses.append(float(m["loss"]))
            served = srv.stats["baskets_served"]
            del state
        finally:
            remote.close()
            local.close()
    finally:
        srv.close()
    assert all(np.isfinite(v) for v in losses), losses
    deadline = time.monotonic() + 10.0
    while _service_threads() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _service_threads(), _service_threads()
    log(f"phase 4e: {len(shards)} token shards over repro:// from a BasketServer on "
        f"loopback: 3 train steps, each batch bitwise the local paths'; losses "
        f"{losses}; baskets served {served}; server closed, no service thread left")
    tree = {"params": live.params, "opt": live.opt, "step": live.step, "err": live.err}
    ckpt = os.path.join(static["workdir"], "ckpt", "ckpt-00000004.bskt")
    ops.reset_launch_counts()
    stage_seconds()
    t0 = time.perf_counter()
    restored, _ = load_pytree(ckpt, template=tree, prefetch=4, heal="auto",
                              device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    stages = stage_seconds()
    back = _flatten_with_paths(restored)
    flat = _flatten_with_paths(tree)
    for k, t in flat.items():
        assert (back[k] is None) if t is None else same_bits(back[k], t), k
    for name in ("bitunshuffle", "byteunshuffle"):
        assert counts[name] > 0, f"{name} not launched on the prefetching restore"
    log(f"phase 4e: prefetching restore (prefetch=4) of {static['gb']:.2f} GB "
        f"{wall_s:.3f} s against phase 4's prefetch=0 restore "
        f"{static['restore_s']:.3f} s, bitwise equal; stages (s): {stages}; "
        f"launches: {counts}")
    del restored, back
    torch.cuda.empty_cache()
    shutil.rmtree(static["workdir"])     # the last phase to read it
    return {"remote_losses": losses, "shards": len(shards), "baskets_served": served,
            "prefetch_restore_s": wall_s, "plain_restore_s": static["restore_s"],
            "prefetch_stages_s": stages, "prefetch_launches": counts}, counts


def run_example(name: str, argv: list) -> int:
    """``examples/<name>.py``'s ``main(argv)``, in this process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


# phase 4b: the tuned, multi-producer save of the trainer's state
TUNED_PRODUCERS = 4


def phase_tuned_save(torch, np, tmp, ops, cfg, state, static, device="cuda"):
    """The trainer's live state at step 4 saved by CheckpointManager with
    ``producers=4`` and ``tune=True`` (the reference's ``checkpoint``
    objective) on every core, restored bitwise name by name; the restored
    params cast to bf16 serve 8 requests of 64 tokens (4 slots, 16 new,
    greedy) with the tokens of the live weights cast to bf16; then
    ``examples/serve_lm_torch.py`` on the card.  ``static`` holds phase 4's
    save of the same state.  Returns (summary, launch counts of the save
    and the restore)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.io import cpu_count
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model
    model = Model(cfg)
    directory = os.path.join(tmp, "tuned")
    tree = {"params": state.params, "opt": state.opt, "step": state.step,
            "err": state.err}
    flat = _flatten_with_paths(tree)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values() if t is not None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mgr = CheckpointManager(directory, workers=cpu_count(),
                            producers=TUNED_PRODUCERS, tune=True)
    ops.reset_launch_counts()
    stage_seconds()
    t0 = time.perf_counter()
    try:
        mgr.save(4, tree, wait=True)
    finally:
        mgr.wait()                               # the save thread is joined
    save_s = time.perf_counter() - t0
    save_counts = ops.launch_counts()
    save_stages = stage_seconds()
    stats = mgr.wait()
    tuner = mgr._tuner
    ratio = stats["raw"] / stats["comp"]
    configs = _configs(os.path.join(directory, "ckpt-00000004.bskt"))
    log(f"phase 4b: tuned save (producers={TUNED_PRODUCERS}, workers={cpu_count()}, "
        f"objective {tuner.objective.name}): decisions by config [branches, raw "
        f"bytes, stored bytes]: {configs}")
    log(f"phase 4b: tuner: {tuner.stats['trials']} trials in "
        f"{tuner.stats['trial_s']:.3f} s (tuned {tuner.stats['tuned']}, shared "
        f"{tuner.stats['shared']}, reused {tuner.stats['reused']}, fallback "
        f"{tuner.stats['fallback']}); save stages (s): {save_stages}; launches "
        f"on the tuned save: {save_counts}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    restored, _ = mgr.restore(template=tree, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_counts = ops.launch_counts()
    restore_stages = stage_seconds()
    back = _flatten_with_paths(restored)
    for k, t in flat.items():
        assert (back[k] is None) if t is None else same_bits(back[k], t), k
    log(f"phase 4b: tuned save {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s), "
        f"ratio {ratio:.4f}; restore {restore_s:.3f} s, bitwise equal (restore "
        f"stages (s): {restore_stages}; launches: {restore_counts}); phase 4's "
        f"static save of the same state: {static['save_s']:.3f} s, ratio "
        f"{static['ratio']:.4f}, restore {static['restore_s']:.3f} s")
    args = launch_serve.parse_args(DENSE_ARGS + ["--device", device])
    params = _to(torch, restored["params"], torch.bfloat16)
    del restored, back
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out, serve_s = launch_serve.serve(model, params, args, cfg.vocab)
    del params
    live = _to(torch, state.params, torch.bfloat16)
    want, _ = launch_serve.serve(model, live, args, cfg.vocab)
    del live
    torch.cuda.synchronize()
    assert sorted(out) == sorted(want) == list(range(args.requests)), sorted(out)
    for rid, toks in want.items():
        assert len(toks) == args.max_new and np.array_equal(out[rid], toks), rid
    n_tok = sum(len(v) for v in out.values())
    log(f"phase 4b: the restored weights (bf16) served {len(out)} requests, "
        f"{n_tok} tokens in {serve_s:.2f} s, tokens equal to the live weights'; "
        f"peak device memory {peak_gb:.2f} GB")
    t0 = time.perf_counter()
    code = run_example("serve_lm_torch",
                       ["--workdir", os.path.join(tmp, "serve_lm"), "--device", device])
    example_s = time.perf_counter() - t0
    assert code == 0, code
    log(f"phase 4b: examples/serve_lm_torch.py on the card: {example_s:.1f} s")
    shutil.rmtree(directory)
    counts = {k: save_counts[k] + restore_counts[k] for k in save_counts}
    return {"gb": nbytes / 1e9, "producers": TUNED_PRODUCERS,
            "objective": tuner.objective.name, "save_s": save_s,
            "restore_s": restore_s, "ratio": ratio, "configs": configs,
            "tuner": dict(tuner.stats), "save_stages_s": save_stages,
            "restore_stages_s": restore_stages, "save_launches": save_counts,
            "restore_launches": restore_counts, "peak_gb": peak_gb,
            "serve_s": serve_s, "example_s": example_s,
            "static": {k: static[k] for k in ("save_s", "restore_s", "ratio")}}, counts


def _start_child(cmd):
    """``cmd`` started in a child process that leads a session of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=ROOT, start_new_session=True)
    return child, cmd, time.perf_counter()


def _finish_child(started, timeout: float):
    """Wait for a ``_start_child``: on a timeout or an error its whole
    process group is killed and waited for; after a normal exit nothing of
    the group may be left (checked, not killed).  Returns
    (CompletedProcess, wall s)."""
    child, cmd, t0 = started
    try:
        out, err = child.communicate(timeout=timeout)
    except BaseException:
        os.killpg(child.pid, signal.SIGKILL)
        child.communicate()
        raise
    left = _live_processes(lambda table: {pid for pid, st in table.items()
                                          if st["pgrp"] == child.pid})
    assert not left, f"the child's process group outlived it: {cmd[:3]}: {left}"
    return subprocess.CompletedProcess(cmd, child.returncode, out, err), \
        time.perf_counter() - t0


def _run_child(cmd, timeout: float):
    return _finish_child(_start_child(cmd), timeout)


def _drive_trainer(workdir, extra):
    """``python -m repro_torch.launch.train`` in a child process, on the
    card unless ``extra`` names another device (``_run_child``)."""
    return _run_child([sys.executable, "-m", "repro_torch.launch.train",
                       "--workdir", workdir] + DRILL_ARGS + extra, timeout=300)


def phase_drill(torch, tmp, device="cuda"):
    """The preemption drill on the card: preempted at step 3 (exit 17), the
    same command without the preemption resumes at step 3 and ends; step 6
    against an uninterrupted run in a fresh workdir."""
    from repro_torch.checkpoint import load_pytree
    cut, whole = os.path.join(tmp, "drill-cut"), os.path.join(tmp, "drill-whole")
    dev = ["--device", device]
    r1, s1 = _drive_trainer(cut, dev + ["--simulate-preempt", "3"])
    assert r1.returncode == 17, (r1.returncode, r1.stderr[-3000:])
    assert "simulated preemption at step 3" in r1.stdout, r1.stdout
    r2, s2 = _drive_trainer(cut, dev)
    assert r2.returncode == 0, (r2.returncode, r2.stderr[-3000:])
    assert "resumed from step 3" in r2.stdout, r2.stdout
    r3, s3 = _drive_trainer(whole, dev)
    assert r3.returncode == 0, (r3.returncode, r3.stderr[-3000:])

    def last(wd):
        with open(os.path.join(wd, "train_log.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        assert lines[-1]["step"] == 6, lines
        return lines

    a, b = last(cut), last(whole)
    loss_rel = abs(a[-1]["loss"] - b[-1]["loss"]) / abs(b[-1]["loss"])
    pa, _ = load_pytree(os.path.join(cut, "ckpt", "ckpt-00000006.bskt"), device=device)
    pb, _ = load_pytree(os.path.join(whole, "ckpt", "ckpt-00000006.bskt"), device=device)
    assert sorted(pa) == sorted(pb)
    rel, bitwise = 0.0, True
    for k in pa:
        if not k.startswith("params."):
            continue
        bitwise &= same_bits(pa[k], pb[k])
        d = (pa[k].double() - pb[k].double()).norm() / pb[k].double().norm()
        rel = max(rel, d.item())
    assert loss_rel <= DRILL_RTOL and rel <= DRILL_RTOL, (loss_rel, rel)
    log(f"phase 4: drill (reduced qwen3-8b, 6 steps, checkpoints at 3 and 6): "
        f"preempted at step 3 with exit 17 ({s1:.1f} s), resumed at step 3 to 6 "
        f"({s2:.1f} s), uninterrupted ({s3:.1f} s); step-6 loss {a[-1]['loss']:.6f} "
        f"against {b[-1]['loss']:.6f} (relative {loss_rel:.2e}), params at step 6 "
        f"within {rel:.2e} relative (bound {DRILL_RTOL}), bit-equal: {bitwise}")
    return {"loss_rel": loss_rel, "params_rel": rel, "params_bitwise": bitwise,
            "seconds": [s1, s2, s3]}


def precond_share(torch, np, host, events_save_s):
    """Device vs host time to precondition the event tree's baskets."""
    from repro_torch.checkpoint.manager import _basket_spans
    from repro_torch.core.policy import choose
    from repro_torch.core.precond import apply_precond
    from repro_torch.kernels import ops
    jobs = []
    for name, arr in host.items():
        spans = _basket_spans(arr.shape, arr.dtype.itemsize)
        raw = arr.reshape(-1).view(np.uint8)
        spec = choose(name, raw[spans[0][2]:spans[0][3]].view(arr.dtype)).precond
        jobs.append((spec, raw, torch.from_numpy(raw).cuda(), spans))
    t0 = time.perf_counter()
    for spec, raw, _, spans in jobs:
        for _, _, lo, hi in spans:
            apply_precond(spec, raw[lo:hi])
    host_s = time.perf_counter() - t0

    def device():
        for spec, _, dev, spans in jobs:
            for _, _, lo, hi in spans:
                ops.precondition(spec, dev[lo:hi])

    dev_s = cuda_ms(device, 1) / 1e3
    log(f"precond share (events, checkpoint profile): device kernels {dev_s:.4f} s "
        f"= {100 * dev_s / events_save_s:.2f}% of the {events_save_s:.3f} s save; "
        f"the numpy host preconditioners take {host_s:.3f} s on one core")
    return {"device_s": dev_s, "host_numpy_s": host_s}


# ---------------------------------------------------------------------------
# phase 5: rwkv6-1.6b served at full width, compressed TP on
# ---------------------------------------------------------------------------

def _serve_once(torch, launch, model, params, args, cfg, group, compressed_tp):
    """One ``launch.serve`` run; returns (outputs, wall s, serve.* spans)."""
    from repro_torch import obs
    from repro_torch.models import rwkv
    from repro_torch.parallel import activation_context
    rwkv.PERF_FLAGS["compressed_tp"] = compressed_tp
    obs.trace.drain()
    try:
        with activation_context(group):
            out, dt = launch.serve(model, params, args, cfg.vocab)
        torch.cuda.synchronize()
    finally:
        rwkv.PERF_FLAGS["compressed_tp"] = False
    spans = [e for e in obs.trace.drain() if e["name"].startswith("serve.")]
    return out, dt, spans


def _span_ms(spans, name):
    """(mean, median, count) of the named spans' durations in ms."""
    durs = sorted(e["dur"] / 1e3 for e in spans if e["name"] == name)
    return sum(durs) / len(durs), durs[len(durs) // 2], len(durs)


def _profile_window(torch, model, params, group, tokens, labels=None):
    """One prefill and three decode steps under torch.profiler, compressed
    TP on over ``group`` (none: off): wall time, device busy time (kernels
    on the one stream, summed) and the kernels that take the most of it.
    ``labels`` ({(module, function name): label}) wraps those functions
    in ``record_function`` ranges for the window and adds, under
    ``split_ms``, each label's calls, device time (the kernels launched
    inside its ranges, summed: not the ranges' spans on the device, which
    hold the gaps where the device waits for the host) and host time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rwkv
    from repro_torch.parallel import activation_context

    def window():
        logits, cache = model.prefill(params, {"tokens": tokens}, 128)
        for i in range(3):
            logits, cache = model.decode_step(params, cache,
                                              logits.argmax(-1)[:, None],
                                              tokens.shape[1] + i)
        torch.cuda.synchronize()

    rwkv.PERF_FLAGS["compressed_tp"] = group is not None
    ctx = activation_context(group) if group is not None else contextlib.nullcontext()
    try:
        with torch.no_grad(), ctx:
            window()
            with _labelled(torch, labels or {}), \
                    profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                window()
                wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rwkv.PERF_FLAGS["compressed_tp"] = False
    names = set((labels or {}).values())
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in names]             # not the ranges' GPU spans
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    quant_ms = sum(e.self_device_time_total for e in kernels
                   if "qpack_kernel" in e.key or "qunpack_kernel" in e.key) / 1e3
    launches = sum(e.count for e in kernels)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "kernel_launches": launches, "quant_kernels_ms": quant_ms,
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}
    if names:
        ranges = [e for e in prof.events() if e.name in names
                  and e.device_type == torch.autograd.DeviceType.CPU]
        out["split_ms"] = {
            name: {"calls": sum(1 for e in ranges if e.name == name),
                   "device_ms": sum(e.device_time_total for e in ranges
                                    if e.name == name) / 1e3,
                   "host_ms": sum(e.cpu_time_total for e in ranges
                                  if e.name == name) / 1e3}
            for name in sorted(names)}
    return out


@contextlib.contextmanager
def _labelled(torch, labels):
    """Wrap each (module, function name) of ``labels`` in a
    ``record_function`` range of its label while the context is open."""
    saved = []
    for (mod, name), label in labels.items():
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _small_model_agrees(torch, cfg_name, group):
    """The reduced model on the card (kernels, NCCL) against the port on the
    CPU (plain versions, gloo), compressed TP on, same weights."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model, rwkv
    from repro_torch.parallel import activation_context
    model = Model(reduced(get_config(cfg_name)))
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    on_card = _to(torch, params, "cuda")
    tokens = torch.randint(2, model.cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    gloo = dist.new_group([0], backend="gloo")
    rwkv.PERF_FLAGS["compressed_tp"] = True
    try:
        with torch.no_grad():
            with activation_context(group):
                lg, cache = model.prefill(on_card, {"tokens": tokens.cuda()}, 128)
                lg2, _ = model.decode_step(on_card, cache, lg.argmax(-1)[:, None], 64)
            with activation_context(gloo):
                rl, rcache = model.prefill(params, {"tokens": tokens}, 128)
                rl2, _ = model.decode_step(params, rcache, lg.argmax(-1)[:, None].cpu(), 64)
    finally:
        rwkv.PERF_FLAGS["compressed_tp"] = False
        dist.destroy_process_group(gloo)
    errs = []
    for got, want in ((lg, rl), (lg2, rl2)):
        got = got.float().cpu()
        assert got.shape == want.shape and torch.isfinite(got).all()
        errs.append(((got - want).norm() / want.norm()).item())
    return errs


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_serve(torch, ops):
    """rwkv6-1.6b at full width through launch.serve, compressed TP on over
    a one-rank NCCL group.  Returns (summary, launch counts of the run)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models.specs import tree_paths
    from repro_torch.parallel import compressed, one_rank_group
    args = launch.parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = launch.build(args)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_paths(params).values())
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (24, 2048, 7168, 65536)
    log(f"phase 5: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.2f} GB bf16 on the card (made in "
        f"{time.perf_counter() - t0:.2f} s)")
    group = one_rank_group("nccl")

    # warm-up, not timed: cuBLAS, the allocator and NCCL's communicator
    warm = launch.parse_args(SERVE_ARGS + ["--requests", str(args.slots),
                                           "--max-new", "2"])
    _serve_once(torch, launch, model, params, warm, cfg, group, True)
    # compressed TP off: the tokens to compare with
    plain_out, plain_dt, plain_spans = _serve_once(torch, launch, model, params,
                                                   args, cfg, group, False)
    # compressed TP on, the main path; layer 0's two projections recorded
    seen = []
    inner = compressed.rowparallel_einsum_compressed

    def record(y, w, out_dtype=None):
        if len(seen) < 2:
            seen.append((y, w))
        return inner(y, w, out_dtype)

    compressed.rowparallel_einsum_compressed = record
    try:
        ops.reset_launch_counts()                      # the serve path starts
        out, dt, spans = _serve_once(torch, launch, model, params, args, cfg,
                                     group, True)
        counts = ops.launch_counts()                   # the serve path ends
    finally:
        compressed.rowparallel_einsum_compressed = inner
    n_req, max_new = int(args.requests), int(args.max_new)
    assert sorted(out) == list(range(n_req)), sorted(out)
    for toks in out.values():
        assert len(toks) == max_new and ((toks >= 0) & (toks < cfg.vocab)).all()
    n_tok = sum(len(v) for v in out.values())
    prefill_ms, prefill_med, n_prefill = _span_ms(spans, "serve.prefill")
    decode_ms, decode_med, n_decode = _span_ms(spans, "serve.decode_step")
    forwards = n_prefill + n_decode
    per_forward = 2 * cfg.n_layers
    log(f"phase 5: compressed TP on: {len(out)} requests, {n_tok} tokens in "
        f"{dt:.3f} s ({n_tok / dt:.1f} tok/s); {n_prefill} prefills of "
        f"{prefill_ms:.2f} ms mean, {n_decode} decode steps of {decode_ms:.2f} ms "
        f"mean ({decode_med:.2f} median); launches {{qpack: {counts['qpack']}, "
        f"qunpack: {counts['qunpack']}}} over {forwards} forward calls")
    for name in ("qpack", "qunpack"):
        assert counts[name] == per_forward * forwards, \
            f"{name}: {counts[name]} launches, want {per_forward} x {forwards}"
    p_prefill_ms, _, _ = _span_ms(plain_spans, "serve.prefill")
    p_decode_ms, p_decode_med, _ = _span_ms(plain_spans, "serve.decode_step")
    agree = sum(int((out[r] == plain_out[r]).sum()) for r in out) / n_tok
    log(f"phase 5: compressed TP off: {len(plain_out)} requests in {plain_dt:.3f} s "
        f"({n_tok / plain_dt:.1f} tok/s); prefill {p_prefill_ms:.2f} ms, decode step "
        f"{p_decode_ms:.2f} ms ({p_decode_med:.2f} median); greedy tokens equal to "
        f"the compressed run's: {100 * agree:.1f} %")

    # one full-width compressed projection of each kind against torch.matmul
    from repro_torch.parallel import activation_context
    proj = {}
    with torch.no_grad(), activation_context(group):
        for label, (y, w) in zip(("time-mix w_o", "channel-mix w_v"), seen):
            got = compressed.rowparallel_einsum_compressed(y, w).float()
            want = torch.matmul(y.float(), w.float())
            rel = ((got - want).norm() / want.norm()).item()
            assert torch.isfinite(got).all() and rel < 0.02, (label, rel)
            proj[label] = {"y": list(y.shape), "w": list(w.shape), "rel_err": rel}
    log(f"phase 5: layer 0 projections on the prefill's inputs, compressed vs "
        f"torch.matmul, relative Frobenius error (bound 0.02): {proj}")
    prompts = torch.randint(2, cfg.vocab, (int(args.slots), int(args.prompt_len)),
                            generator=torch.Generator().manual_seed(3)).cuda()
    prof = _profile_window(torch, model, params, group, prompts)
    log(f"phase 5: profiled window (1 prefill + 3 decode steps, compressed on): "
        f"{prof}")
    small = _small_model_agrees(torch, args.arch, group)
    assert max(small) < 0.02, small
    log(f"phase 5: reduced {args.arch} on the card vs the port on the CPU, "
        f"compressed on: prefill / decode logits relative error {small}")
    summary = {"requests": len(out), "tokens": n_tok, "wall_s": dt,
               "tok_s": n_tok / dt, "prefill_ms": prefill_ms, "prefills": n_prefill,
               "decode_step_ms": decode_ms, "decode_step_median_ms": decode_med,
               "decode_steps": n_decode,
               "plain": {"wall_s": plain_dt, "tok_s": n_tok / plain_dt,
                         "prefill_ms": p_prefill_ms, "decode_step_ms": p_decode_ms,
                         "decode_step_median_ms": p_decode_med},
               "greedy_agreement": agree, "projections": proj, "profile": prof,
               "small_model_rel_err": small, "params": n_params,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return summary, counts


# ---------------------------------------------------------------------------
# phase 6: qwen3-8b served at full width and full depth
# ---------------------------------------------------------------------------

DENSE_ARGS = ["--arch", "qwen3-8b", "--requests", "8", "--prompt-len", "64",
              "--slots", "4", "--max-len", "128", "--max-new", "16"]
KV_CONSISTENCY_RTOL = 1e-4        # decode after prefill vs one longer prefill
Q_CHUNK_RTOL = 1e-4               # 4096-token prefill, q_chunk 512 vs 0
CARD_VS_CPU_RTOL = 3e-2           # the reduced models, as in phase 5


def _rel(torch, got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm()).item()


def _dense_checks(torch, cfg):
    """The dense path's three checks at full width: the prompt and one
    more token decoded a token at a time from a float32 KV cache against
    one prefill of them all, and query chunking against none (depth 2,
    float32 params and compute: both sides compute the same function, so
    only float32 rounding separates them), and the reduced qwen3-8b and
    gemma2-9b on the card against the port on the CPU (bf16 weights)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    out = {}
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = Model(cfg2)
    params = model.init(torch.Generator(device="cuda").manual_seed(6))
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(2, cfg.vocab, (2, 64), generator=gen).cuda()
    tokens = torch.cat([prompt, torch.randint(2, cfg.vocab, (2, 1), generator=gen).cuda()], 1)
    with torch.no_grad():
        cache = model.init_cache(2, 128, cache_dtype=torch.float32, device="cuda")
        for pos in range(tokens.shape[1]):
            step, cache = model.decode_step(params, cache, tokens[:, pos:pos + 1], pos)
        longer, _ = model.prefill(params, {"tokens": tokens}, 128)
    out["kv_cache_rel_err"] = _rel(torch, step, longer)
    assert torch.isfinite(step).all() and out["kv_cache_rel_err"] < KV_CONSISTENCY_RTOL, out
    long_prompt = torch.randint(2, cfg.vocab, (1, 4096), generator=gen).cuda()
    chunked = Model(dataclasses.replace(cfg2, q_chunk=512))
    with torch.no_grad():
        h_c, _ = chunked.forward(params, {"tokens": long_prompt})
        h_p, _ = model.forward(params, {"tokens": long_prompt})
        l_c, _ = chunked.prefill(params, {"tokens": long_prompt}, 4096)
        l_p, _ = model.prefill(params, {"tokens": long_prompt}, 4096)
    out["q_chunk_hidden_rel_err"] = _rel(torch, h_c, h_p)
    out["q_chunk_logits_rel_err"] = _rel(torch, l_c, l_p)
    assert torch.isfinite(h_c).all(), "q_chunk hidden states not finite"
    assert max(out["q_chunk_hidden_rel_err"], out["q_chunk_logits_rel_err"]) \
        < Q_CHUNK_RTOL, out
    del params, cache, h_c, h_p
    torch.cuda.empty_cache()
    for arch in ("qwen3-8b", "gemma2-9b"):
        small = Model(reduced(get_config(arch)))
        p_cpu = small.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        p_card = _to(torch, p_cpu, "cuda")
        tokens = torch.randint(2, small.cfg.vocab, (2, 64),
                               generator=torch.Generator().manual_seed(1))
        errs = []
        with torch.no_grad():
            lg, cache = small.prefill(p_card, {"tokens": tokens.cuda()}, 128)
            rl, rcache = small.prefill(p_cpu, {"tokens": tokens}, 128)
            errs.append(_rel(torch, lg, rl))
            tok = rl.argmax(-1)[:, None]
            for i in range(3):
                lg, cache = small.decode_step(p_card, cache, tok.cuda(), 64 + i)
                rl, rcache = small.decode_step(p_cpu, rcache, tok, 64 + i)
                errs.append(_rel(torch, lg, rl))
                tok = rl.argmax(-1)[:, None]
        assert torch.isfinite(lg).all() and max(errs) < CARD_VS_CPU_RTOL, (arch, errs)
        out[f"reduced_{arch}_card_vs_cpu_rel_err"] = errs
    return out


def phase_dense_serve(torch, ops):
    """qwen3-8b at full width and depth through launch.serve: a warm-up
    run, then the timed one; its bound, a profiled window and the dense
    path's checks.  Returns (summary, launch counts of the timed run)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models.specs import tree_paths
    args = launch.parse_args(DENSE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = launch.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaves = tree_paths(params)
    n_params = sum(t.numel() for t in leaves.values())
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == (36, D, H, KV, FF, VOCAB)
    log(f"phase 6: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB "
        f"bf16 on the card (made in {build_s:.2f} s)")
    launch.serve(model, params, args, cfg.vocab)     # warm-up, not timed
    torch.cuda.synchronize()
    from repro_torch import obs
    obs.trace.drain()
    ops.reset_launch_counts()                        # the dense serve path starts
    out, dt = launch.serve(model, params, args, cfg.vocab)
    torch.cuda.synchronize()
    counts = ops.launch_counts()                     # the dense serve path ends
    spans = [e for e in obs.trace.drain() if e["name"].startswith("serve.")]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_req, max_new = int(args.requests), int(args.max_new)
    assert sorted(out) == list(range(n_req)), sorted(out)
    for toks in out.values():
        assert len(toks) == max_new and ((toks >= 0) & (toks < cfg.vocab)).all()
    n_tok = sum(len(v) for v in out.values())
    prefill_ms, prefill_med, n_prefill = _span_ms(spans, "serve.prefill")
    decode_ms, decode_med, n_decode = _span_ms(spans, "serve.decode_step")
    # a decode step reads every weight once but the embedding rows it gathers
    weight_bytes = sum(t.numel() * t.element_size() for k, t in leaves.items()
                       if k != "embed")
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 6: {len(out)} requests, {n_tok} tokens in {dt:.3f} s "
        f"({n_tok / dt:.1f} tok/s); {n_prefill} prefills of {prefill_ms:.2f} ms mean "
        f"({prefill_med:.2f} median), {n_decode} decode steps of {decode_ms:.2f} ms "
        f"mean ({decode_med:.2f} median); decode bound {bound_ms:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB of weights but the embedding at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak {peak_gb:.2f} GB; "
        f"port kernel launches {counts}")
    prompts = torch.randint(2, cfg.vocab, (int(args.slots), int(args.prompt_len)),
                            generator=torch.Generator().manual_seed(3)).cuda()
    prof = _profile_window(torch, model, params, None, prompts)
    log(f"phase 6: profiled window (1 prefill + 3 decode steps): {prof}")
    del params, leaves
    torch.cuda.empty_cache()
    checks = _dense_checks(torch, cfg)
    log(f"phase 6: checks (KV cache and q_chunk bound {KV_CONSISTENCY_RTOL}, card vs "
        f"CPU bound {CARD_VS_CPU_RTOL}, relative Frobenius errors): {checks}")
    summary = {"requests": len(out), "tokens": n_tok, "wall_s": dt,
               "tok_s": n_tok / dt, "prefill_ms": prefill_ms,
               "prefill_median_ms": prefill_med, "prefills": n_prefill,
               "decode_step_ms": decode_ms, "decode_step_median_ms": decode_med,
               "decode_steps": n_decode, "decode_bound_ms": bound_ms,
               "weight_gb_read_a_step": weight_bytes / 1e9, "params": n_params,
               "peak_gb": peak_gb, "build_s": build_s, "profile": prof,
               "checks": checks}
    return summary, counts


# ---------------------------------------------------------------------------
# phases 7-8: jamba (one group) and llama4-scout (depth 4) served at full width
# ---------------------------------------------------------------------------

FAMILY_ARGS = ["--requests", "8", "--prompt-len", "64", "--slots", "4",
               "--max-len", "128", "--max-new", "16"]
# arch -> (layers kept, published widths: d_model, heads, kv heads, d_ff,
# vocab, experts, experts a token)
FAMILY_SERVES = {
    "jamba-v0.1-52b": (8, (4096, 32, 8, 14336, 65536, 16, 2)),
    "llama4-scout-17b-a16e": (4, (5120, 40, 8, 8192, 202048, 16, 1)),
}


def _family_labels():
    """The new layer types' pieces, timed apart in the profiled window."""
    from repro_torch.models import moe, ssm
    return {(ssm, "mamba"): "mamba (prefill)", (ssm, "mamba_step"): "mamba (decode)",
            (ssm, "_conv1d"): "mamba conv (prefill)",
            (ssm, "_ssm_params"): "mamba dt, exp(dt A), dt B x",
            (ssm, "_chunk_scan"): "mamba scan", (moe, "moe_ffn"): "moe (all)",
            (moe, "_top_k"): "moe top-k sorts",
            (moe, "_dispatch_gather"): "moe dispatch",
            (moe, "_combine_gather"): "moe combine",
            (moe, "_expert_ffn"): "moe expert GEMMs"}


def phase_family_serve(torch, ops, phase, arch):
    """``arch`` at full width, depth cut to FAMILY_SERVES' layers, through
    launch.serve: a warm-up run, then the timed one; its decode bound, peak
    memory and a profiled window with the new layers split out.  Returns
    (summary, launch counts of the timed run)."""
    import dataclasses
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.specs import tree_paths
    layers, widths = FAMILY_SERVES[arch]
    full = get_config(arch)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.d_ff, full.vocab,
            full.n_experts, full.experts_per_token) == widths, arch
    cfg = dataclasses.replace(full, n_layers=layers)
    args = launch.parse_args(["--arch", arch] + FAMILY_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = launch.build(args, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaves = tree_paths(params)
    n_params = sum(t.numel() for t in leaves.values())
    log(f"{phase}: {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
        f"({[(p.mixer, p.ffn) for p in cfg.pattern]}), d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB bf16 "
        f"on the card (made in {build_s:.2f} s)")
    launch.serve(model, params, args, cfg.vocab)     # warm-up, not timed
    torch.cuda.synchronize()
    obs.trace.drain()
    ops.reset_launch_counts()                        # this serve path starts
    out, dt = launch.serve(model, params, args, cfg.vocab)
    torch.cuda.synchronize()
    counts = ops.launch_counts()                     # this serve path ends
    spans = [e for e in obs.trace.drain() if e["name"].startswith("serve.")]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_req, max_new = int(args.requests), int(args.max_new)
    assert sorted(out) == list(range(n_req)), sorted(out)
    for toks in out.values():
        assert len(toks) == max_new and ((toks >= 0) & (toks < cfg.vocab)).all()
    n_tok = sum(len(v) for v in out.values())
    prefill_ms, prefill_med, n_prefill = _span_ms(spans, "serve.prefill")
    decode_ms, decode_med, n_decode = _span_ms(spans, "serve.decode_step")
    # every expert's weights are read at every step (the dispatch runs
    # each expert's GEMM), so the bound is every weight but the embedding
    weight_bytes = sum(t.numel() * t.element_size() for k, t in leaves.items()
                       if k != "embed")
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{phase}: {len(out)} requests, {n_tok} tokens in {dt:.3f} s "
        f"({n_tok / dt:.1f} tok/s); {n_prefill} prefills of {prefill_ms:.2f} ms mean "
        f"({prefill_med:.2f} median), {n_decode} decode steps of {decode_ms:.2f} ms "
        f"mean ({decode_med:.2f} median); decode bound {bound_ms:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB of weights but the embedding at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak {peak_gb:.2f} GB; "
        f"port kernel launches {counts}")
    prompts = torch.randint(2, cfg.vocab, (int(args.slots), int(args.prompt_len)),
                            generator=torch.Generator().manual_seed(3)).cuda()
    prof = _profile_window(torch, model, params, None, prompts, _family_labels())
    log(f"{phase}: profiled window (1 prefill + 3 decode steps): {prof}")
    del params, leaves, model
    torch.cuda.empty_cache()
    summary = {"layers": cfg.n_layers, "requests": len(out), "tokens": n_tok,
               "wall_s": dt, "tok_s": n_tok / dt, "prefill_ms": prefill_ms,
               "prefill_median_ms": prefill_med, "prefills": n_prefill,
               "decode_step_ms": decode_ms, "decode_step_median_ms": decode_med,
               "decode_steps": n_decode, "decode_bound_ms": bound_ms,
               "weight_gb_read_a_step": weight_bytes / 1e9, "params": n_params,
               "peak_gb": peak_gb, "build_s": build_s, "profile": prof}
    return summary, counts


# ---------------------------------------------------------------------------
# phase 9: the new families' checks at full width
# ---------------------------------------------------------------------------

MOE_LOOP_RTOL = 1e-5              # dispatch vs a loop over the experts, float32
MAMBA_STEP_ATOL = 5e-3            # the reference's invariant (tests/test_models.py)
ENCDEC_RTOL = 1e-4                # decode vs the teacher-forced forward, float32
CARD_VS_CPU_F32_RTOL = 1e-4       # the reduced families, float32


def _moe_vs_loop(torch):
    """One llama4-scout MoE layer at full width in float32, dropless
    (capacity_factor = E / K), against sum_k gate_k FFN_{e_k}(x) + the
    shared expert, computed expert by expert."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.specs import init_params
    cfg = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    p = init_params(moe.moe_specs(cfg), torch.Generator(device="cuda").manual_seed(11))
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(device="cuda")
                    .manual_seed(12), device="cuda")
    with torch.no_grad():
        out, aux = moe.moe_ffn(p, x, cfg)
        probs = torch.softmax(x @ p["router"], -1)
        gate, idx = probs.max(-1)                  # top-1: its gate renormalises to 1
        want = moe._dense_ffn(p["shared"], x, cfg.ffn_act)
        for e in range(cfg.n_experts):
            sel = idx == e
            if sel.any():
                w = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
                want[sel] += moe._dense_ffn(w, x[sel][None], cfg.ffn_act)[0]
    rel = _rel(torch, out, want)
    n_bytes = sum(t.numel() * t.element_size() for t in (p["w_gate"], p["w_up"],
                                                         p["w_down"]))
    assert torch.isfinite(out).all() and rel < MOE_LOOP_RTOL, rel
    return {"rel_err": rel, "experts_gb": n_bytes / 1e9,
            "lb_loss": aux["lb_loss"].item(), "z_loss": aux["z_loss"].item(),
            "experts_used": int(torch.unique(idx).numel())}


def _mamba_full_vs_steps(torch):
    """One jamba mamba layer at full width (d_inner 8192, state 16), bf16
    input at half unit scale, as the reference's invariant: the full pass
    over 64 tokens with its state against 64 decode steps from zero."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.specs import init_params
    cfg = get_config("jamba-v0.1-52b")
    p = init_params(ssm.mamba_specs(cfg), torch.Generator(device="cuda").manual_seed(9))
    x = (torch.randn((2, 64, cfg.d_model), generator=torch.Generator(device="cuda")
                     .manual_seed(5), device="cuda") * 0.5).to(torch.bfloat16)
    with torch.no_grad():
        full, st_full = ssm.mamba(p, x, cfg, return_state=True)
        st = ssm.init_mamba_state(cfg, 2, device="cuda")
        ys = []
        for t in range(x.shape[1]):
            y, st = ssm.mamba_step(p, x[:, t:t + 1], st, cfg)
            ys.append(y)
    steps = torch.cat(ys, 1)
    out = {"out_max_abs": (full.float() - steps.float()).abs().max().item(),
           "out_rel_err": _rel(torch, steps, full),
           "ssm_max_abs": (st_full["ssm"] - st["ssm"]).abs().max().item(),
           "ssm_rel_err": _rel(torch, st["ssm"], st_full["ssm"]),
           "conv_equal": bool(torch.equal(st["conv"], st_full["conv"].float()))}
    assert torch.isfinite(full).all() and out["out_max_abs"] < MAMBA_STEP_ATOL \
        and out["ssm_max_abs"] < MAMBA_STEP_ATOL, out
    return out


def _mamba_remat(torch):
    """One jamba mamba layer at full width (d_inner 8192, state 16) through
    forward and backward at S = 4096 (bf16, batch 1), with its chunk steps
    recomputed in the backward (the port's path) and without (every
    chunk's (L, B, d_inner, d_state) tensors kept): the gradients of the
    input and every weight bitwise equal, the peak memory of each."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.specs import init_params
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = get_config("jamba-v0.1-52b")
    p = init_params(ssm.mamba_specs(cfg), torch.Generator(device="cuda").manual_seed(9))
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (torch.randn((1, 4096, cfg.d_model), generator=gen, device="cuda") * 0.5
         ).to(torch.bfloat16)
    dy = torch.randn((1, 4096, cfg.d_model), generator=gen, device="cuda"
                     ).to(torch.bfloat16)

    def run():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), p)
        xx = x.detach().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = ssm.mamba(leaves, xx, cfg)
        grads = torch.autograd.grad(out, [xx] + tree_leaves(leaves), grad_outputs=dy)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, \
            (torch.cuda.max_memory_allocated() - held) / 1e9, out.detach(), grads

    torch.use_deterministic_algorithms(True, warn_only=True)
    plain = ssm.recompute
    try:
        ms, peak, out, grads = run()
        ssm.recompute = lambda fn, *args, context_fn=None: fn(*args)
        ms_kept, peak_kept, out_kept, grads_kept = run()
    finally:
        ssm.recompute = plain
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(out).all() and same_bits(out, out_kept)
    differ = [i for i, (a, b) in enumerate(zip(grads, grads_kept)) if not same_bits(a, b)]
    assert not differ, f"mamba chunk recompute: gradients {differ} differ"
    return {"peak_gb_recomputed": peak, "peak_gb_kept": peak_kept,
            "ms_recomputed": ms, "ms_kept": ms_kept, "grads_bitwise": len(grads)}


def _mamba_bf16_y(torch):
    """The ``mamba_bf16_y`` variant at full width (one jamba mamba layer,
    bf16, 2 x 512) against the default path: within the CPU tests' bf16
    bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.specs import init_params
    cfg = get_config("jamba-v0.1-52b")
    p = init_params(ssm.mamba_specs(cfg), torch.Generator(device="cuda").manual_seed(9))
    x = (torch.randn((2, 512, cfg.d_model), generator=torch.Generator(device="cuda")
                     .manual_seed(7), device="cuda") * 0.5).to(torch.bfloat16)
    with torch.no_grad():
        want = ssm.mamba(p, x, cfg)
        ssm.PERF_FLAGS["mamba_bf16_y"] = True
        try:
            got = ssm.mamba(p, x, cfg)
        finally:
            ssm.PERF_FLAGS["mamba_bf16_y"] = False
    rel = _rel(torch, got, want)
    assert torch.isfinite(got).all() and rel < VARIANT_RTOL, rel
    return {"rel_err": rel, "bits_equal": same_bits(got, want)}


def _drawn_weights(torch, model, generator):
    """float32 weights drawn as the CPU tests draw them, on ``generator``'s
    device: normal leaves at scale / sqrt(d_model), "ones" leaves their
    constant, zeros zero.  ``init_params`` takes the number of groups for
    a stacked leaf's fan-in (ROADMAP, reference behaviour 6), so its
    random deep models amplify float32 rounding past the bounds of the
    cache checks (``_encdec_checks`` reports the spread of two cache-free
    forwards under its weights); these do not."""
    from repro_torch.models.specs import _unflatten, tree_paths
    dev = generator.device
    flat = {}
    for path, spec in sorted(tree_paths(model.param_specs()).items()):
        if spec.init == "normal":
            flat[path] = torch.randn(spec.shape, generator=generator, device=dev) \
                * (spec.scale / model.cfg.d_model ** 0.5)
        else:
            flat[path] = torch.full(spec.shape, spec.scale if spec.init == "ones"
                                    else 0.0, device=dev)
    return _unflatten(flat)


def _encdec_checks(torch):
    """seamless-m4t-medium whole (12 + 12 layers) in float32: a prefill of
    8 tokens over 64 frames against the teacher-forced forward, its bf16
    cross cache against the encoder's projections, and 8 decode steps from
    a float32 cache (cross leaves filled from the encoder) against the
    forward, position by position."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.model import _index
    from repro_torch.models.specs import tree_paths
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"), dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(14)
    frames = torch.randn((2, 64, cfg.d_model), generator=gen, device="cuda")
    tokens = torch.randint(2, cfg.vocab, (2, 16), generator=gen, device="cuda")
    P = 8
    out = {}
    # the model's own float32 spread under init_params' weights: two
    # cache-free forwards, of 16 and of 9 tokens, at the first 9 positions
    params = model.init(torch.Generator(device="cuda").manual_seed(13))
    with torch.no_grad():
        h16, _ = model.forward(params, {"tokens": tokens, "frames": frames})
        h9, _ = model.forward(params, {"tokens": tokens[:, :9], "frames": frames})
        out["init_params_forward_16_vs_9_rel_err"] = _rel(
            torch, model.unembed(params, h16[:, :9]), model.unembed(params, h9))
    del params, h16, h9
    params = _drawn_weights(torch, model, torch.Generator(device="cuda").manual_seed(13))
    out["params"] = sum(t.numel() for t in tree_paths(params).values())
    with torch.no_grad():
        h, _ = model.forward(params, {"tokens": tokens, "frames": frames})
        want = model.unembed(params, h)                              # (2, 16, V)
        logits, cache = model.prefill(params, {"tokens": tokens[:, :P],
                                               "frames": frames}, 32)
        out["prefill_rel_err"] = _rel(torch, logits, want[:, P - 1])
        enc = model.encode(params, frames)
        xk = [L._project(enc, _index(params["layers"], g)["l0"]["xattn"]["wk"])
              for g in range(cfg.n_groups)]
        got = cache["l0"]["cross"]["k"].float()
        out["cross_cache_rel_err"] = _rel(torch, got, torch.stack(xk))
        f32 = model.init_cache(2, 32, enc_len=64, cache_dtype=torch.float32,
                               device="cuda")
        for g in range(cfg.n_groups):
            sub = _index(params["layers"], g)["l0"]["xattn"]
            f32["l0"]["cross"]["k"][g] = L._project(enc, sub["wk"])
            f32["l0"]["cross"]["v"][g] = L._project(enc, sub["wv"])
        errs = []
        for pos in range(tokens.shape[1]):
            step, f32 = model.decode_step(params, f32, tokens[:, pos:pos + 1], pos)
            if pos >= P:
                errs.append(_rel(torch, step, want[:, pos]))
    out["decode_rel_err"] = errs
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert max([out["prefill_rel_err"]] + errs) < ENCDEC_RTOL, out
    # bf16 rounding of float32 projections: within half a bf16 step
    assert out["cross_cache_rel_err"] < 2.0 ** -8, out
    del params, cache, f32
    torch.cuda.empty_cache()
    return out


def _reduced_families_agree(torch):
    """The reduced llama4-scout, jamba and seamless on the card against the
    port on the CPU in float32, weights from ``_drawn_weights`` (bf16, or
    init_params' weights, would route tokens differently on the routers'
    near-ties, see tests/test_torch_families.py): a prefill and three
    decode steps."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    out = {}
    for arch in ("llama4-scout-17b-a16e", "jamba-v0.1-52b", "seamless-m4t-medium"):
        small = Model(dataclasses.replace(reduced(get_config(arch)), dtype="float32"))
        p_cpu = _drawn_weights(torch, small, torch.Generator().manual_seed(0))
        p_card = _to(torch, p_cpu, "cuda")
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(2, small.cfg.vocab, (2, 64), generator=gen)}
        if small.cfg.is_encdec:
            batch["frames"] = torch.randn((2, 16, small.cfg.d_model), generator=gen)
        errs = []
        with torch.no_grad():
            lg, cache = small.prefill(p_card, _to(torch, batch, "cuda"), 128)
            rl, rcache = small.prefill(p_cpu, batch, 128)
            errs.append(_rel(torch, lg, rl))
            tok = rl.argmax(-1)[:, None]
            for i in range(3):
                lg, cache = small.decode_step(p_card, cache, tok.cuda(), 64 + i)
                rl, rcache = small.decode_step(p_cpu, rcache, tok, 64 + i)
                errs.append(_rel(torch, lg, rl))
                tok = rl.argmax(-1)[:, None]
        assert torch.isfinite(lg).all() and max(errs) < CARD_VS_CPU_F32_RTOL, (arch, errs)
        out[arch] = errs
    return out


def phase_family_checks(torch):
    out = {}
    for name, check in (("moe_vs_expert_loop", _moe_vs_loop),
                        ("mamba_full_vs_steps", _mamba_full_vs_steps),
                        ("mamba_chunk_remat_s4096", _mamba_remat),
                        ("mamba_bf16_y_variant", _mamba_bf16_y),
                        ("encdec_vs_forward", _encdec_checks),
                        ("reduced_card_vs_cpu_f32", _reduced_families_agree)):
        t0 = time.perf_counter()
        out[name] = check(torch)
        torch.cuda.empty_cache()
        log(f"phase 9: {name} ({time.perf_counter() - t0:.1f} s): {out[name]}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the port's dry run
# ---------------------------------------------------------------------------

DRYRUN_ARGS = ["--arch", "qwen3-8b", "--shape", "all", "--mesh", "both"]
DRYRUN_CELLS = 6                   # 3 shapes x the (16, 16) and (2, 16, 16) meshes
# the layers' variants on: one cell (the prefill's, whose q_chunk
# probabilities the bf16 variant stores; a forward traces fastest)
DRYRUN_PERF_ARGS = ["--arch", "qwen3-8b", "--shape", "prefill_32k", "--mesh", "single",
                    "--perf", "rms_einsum,softmax_bf16_probs"]
# train_4k's per-device peak (GiB) with every activation kept, from this
# phase on an H100 before the port honoured remat, beside this run's
# under remat="full"
NO_REMAT_PEAK_GIB = {"train_4k 16x16": 172.69, "train_4k 2x16x16": 185.69}
# the trainer's own cell: phase 4's configuration on a (1, 1) fake world
TRAINER_CELL = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=1)
rec = dryrun.run_shape(cfg, ShapeSpec("train_128", 128, 8, "train"), (1, 1),
                       train_kwargs={"compress_grads": True, "accum": 1})
print("RECORD " + json.dumps(rec))
"""


def card_rates(torch) -> dict:
    """The card's bf16 GEMM rate (8192^3) and device-to-device copy rate
    (1 GiB read and written), by events: beside the data sheet's figures
    the dry run's roofline divides by."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    gemm_ms = cuda_ms(lambda: a @ b, 20, rounds=3)
    x = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), 20, rounds=3)
    del a, b, x, y
    torch.cuda.empty_cache()
    return {"bf16_gemm_tflop_s": 2 * 8192 ** 3 / gemm_ms / 1e9,
            "copy_gb_s": 2 * (1 << 30) / copy_ms / 1e6}


def phase_dryrun(torch, tmp, train):
    """``python -m repro_torch.launch.dryrun`` over qwen3-8b's three shapes
    on both production meshes in a child process (``_run_child``; a fake
    world of 256 or 512 ranks is that process's default group): all six
    cells OK, each one's per-device peak, roofline terms and
    mfu_vs_roofline printed; then the trainer's own cell on a (1, 1) fake
    world, held to phase 4's real step: its argument bytes equal to the
    live state's and the batch's, its dot FLOPs equal to FlopCounterMode's
    over one real step; its peak and roofline printed beside phase 4's
    measured peak and step."""
    from repro_torch.launch.dryrun import H100
    out_dir = os.path.join(tmp, "dryrun")
    perf_dir = os.path.join(tmp, "dryrun-perf")
    # the children at once: none needs the card, and each is one process
    cell = _start_child([sys.executable, "-c", TRAINER_CELL])
    perf = _start_child([sys.executable, "-m", "repro_torch.launch.dryrun"]
                        + DRYRUN_PERF_ARGS + ["--out", perf_dir])
    try:
        r, wall = _run_child([sys.executable, "-m", "repro_torch.launch.dryrun"]
                             + DRYRUN_ARGS + ["--out", out_dir], timeout=600)
    finally:
        try:
            r2, wall2 = _finish_child(cell, timeout=300)
        finally:
            r3, wall3 = _finish_child(perf, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stdout[-3000:], r.stderr[-3000:])
    oks = [line for line in r.stdout.splitlines() if line.startswith("OK ")]
    assert len(oks) == DRYRUN_CELLS and "all dry-run cells passed" in r.stdout, \
        r.stdout[-3000:]
    cells = {}
    for fn in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, fn)) as fh:
            rec = json.load(fh)
        t = {k: v * 1e3 for k, v in rec["roofline_s"].items()}
        peak_gib = rec["per_device"]["peak_bytes"] / 2 ** 30
        cells[f"{rec['shape']} {rec['mesh']}"] = {
            "peak_gib": peak_gib, "roofline_ms": t,
            "bottleneck": rec["bottleneck"], "mfu_vs_roofline": rec["mfu_vs_roofline"],
            "per_device": rec["per_device"], "collectives": rec["collectives"]["total"],
            "trace_s": rec["lower_s"]}
        log(f"phase 10: {rec['arch']} {rec['shape']} {rec['mesh']}: peak "
            f"{peak_gib:.2f} GiB a device; roofline compute {t['compute']:.2f} ms, "
            f"memory {t['memory']:.2f} ms, collective {t['collective']:.2f} ms -> "
            f"{rec['bottleneck']}; mfu_vs_roofline {rec['mfu_vs_roofline']:.4f}; "
            f"{rec['collectives']['total']['count']:.0f} collectives")
    assert len(cells) == DRYRUN_CELLS, sorted(cells)
    for key, before in NO_REMAT_PEAK_GIB.items():
        log(f"phase 10: {key} peak under remat=full {cells[key]['peak_gib']:.2f} GiB "
            f"a device against {before:.2f} GiB with every activation kept")
    assert r3.returncode == 0 and "all dry-run cells passed" in r3.stdout, \
        (r3.returncode, r3.stdout[-3000:], r3.stderr[-3000:])
    (fn,) = os.listdir(perf_dir)
    with open(os.path.join(perf_dir, fn)) as fh:
        prec = json.load(fh)
    pt = {k: v * 1e3 for k, v in prec["roofline_s"].items()}
    key = f"{prec['shape']} {prec['mesh']}"
    perf_cell = {"cell": key, "peak_gib": prec["per_device"]["peak_bytes"] / 2 ** 30,
                 "roofline_ms": pt, "mfu_vs_roofline": prec["mfu_vs_roofline"],
                 "trace_s": prec["lower_s"], "wall_s": wall3}
    log(f"phase 10: {key} with --perf rms_einsum,softmax_bf16_probs: peak "
        f"{perf_cell['peak_gib']:.2f} GiB (without: {cells[key]['peak_gib']:.2f}); "
        f"roofline compute {pt['compute']:.2f} ms, memory {pt['memory']:.2f} ms "
        f"(without: {cells[key]['roofline_ms']['memory']:.2f}), collective "
        f"{pt['collective']:.2f} ms; mfu_vs_roofline {prec['mfu_vs_roofline']:.4f} "
        f"({wall3:.1f} s)")
    assert r2.returncode == 0, (r2.returncode, r2.stderr[-3000:])
    rec = json.loads(next(line for line in r2.stdout.splitlines()
                          if line.startswith("RECORD "))[len("RECORD "):])
    pd, t = rec["per_device"], {k: v * 1e3 for k, v in rec["roofline_s"].items()}
    want_args = train["nbytes"] + train["batch_bytes"]
    assert pd["arg_bytes"] == want_args, (pd["arg_bytes"], want_args)
    assert pd["dot_flops"] == train["step_flops"], (pd["dot_flops"], train["step_flops"])
    rates = card_rates(torch)
    log(f"phase 10: the trainer's cell (qwen3-8b depth 1, 8 x 128, compressed "
        f"gradients, (1, 1)): argument bytes {pd['arg_bytes']} = the live state's "
        f"and the batch's; dot FLOPs {pd['dot_flops']:.6e} = FlopCounterMode's over "
        f"phase 4's real step; peak {pd['peak_bytes'] / 1e9:.2f} GB against phase 4's "
        f"measured {train['peak_gb']:.2f} GB; roofline compute {t['compute']:.2f} ms, "
        f"memory {t['memory']:.2f} ms -> {rec['bottleneck']}, against the measured "
        f"step {train['step_ms']:.1f} ms")
    log(f"phase 10: the card's bf16 GEMM {rates['bf16_gemm_tflop_s']:.1f} TFLOP/s and "
        f"copy {rates['copy_gb_s']:.1f} GB/s (events) against the data sheet's "
        f"{H100['flops_bf16'] / 1e12:.1f} TFLOP/s and {H100['hbm_bytes_per_s'] / 1e9:.0f} "
        f"GB/s the dry run divides by; dry run {wall:.1f} s, trainer's cell {wall2:.1f} s")
    return {"cells": cells, "perf_cell": perf_cell, "trainer_cell": {
        "per_device": pd, "roofline_ms": t, "bottleneck": rec["bottleneck"],
        "measured_step_ms": train["step_ms"], "measured_peak_gb": train["peak_gb"]},
        "card_rates": rates, "dryrun_s": wall, "trainer_cell_s": wall2}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.kernels import _build, ops, ref

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {os.cpu_count()} CPU cores")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc: {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    workers = os.cpu_count() or 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    phase_s = {}
    mark = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        phase_s[phase] = now - mark[0]
        log(f"{phase}: {phase_s[phase]:.1f} s")
        mark[0] = now

    try:
        rows = phase_kernels(torch, ops.PRECOND_KERNELS, ref)
        phase_bitshuffle(torch, ops.KERNELS, ref)
        large = phase_byteshuffle(torch, ops.KERNELS, ref)
        rows += phase_quant_kernels(torch, ops.KERNELS, ref)
        qpack_large = phase_qpack(torch, ops.KERNELS, ref)
        large.update(phase_scan(torch, ops.KERNELS, ref))
        split = phase_launch_split(torch, ops.KERNELS)
        for row in rows:
            row["at_small_shape"] = split[row["name"]]
            if f"{row['name']} lm_head" in split:
                row["at_lm_head"] = split[f"{row['name']} lm_head"]
            if f"{row['name']} main" in split:
                row["at_basket"] = split[f"{row['name']} main"]
            if row["name"] in large:
                row["at_100mb"] = large[row["name"]]
            if row["name"] == "qpack":
                row["at_32768x2048"] = qpack_large
        bitshuffle_targets(rows, split)
        byteshuffle_targets(rows, split, large)
        qpack_targets(rows, split, qpack_large)
        done("phase 1")
        phase_golden(torch, np, tmp)
        done("phase 2")
        ops.reset_launch_counts()                      # the event tree's path
        events, host_events, _ = phase_events(torch, np, tmp, workers)
        counts = ops.launch_counts()
        log(f"launches on the event tree's save and restore: {counts}")
        share = precond_share(torch, np, host_events, events["save_s"])
        done("phase 3")
        ops.reset_launch_counts()                      # the tuned zigzag path
        zigzag = phase_zigzag_save(torch, np, tmp, host_events, workers)
        zz_counts = ops.launch_counts()
        log(f"launches on the tuned zigzag save and restore: {zz_counts}")
        for name in ("zigzag", "unzigzag"):
            assert zz_counts[name] > 0, f"{name} never launched in phase 3b"
        done("phase 3b")
        # the main path: the trainer's save, then its restore
        ops.reset_launch_counts()
        cfg4 = qwen3_8b_depth1_specs()[0]
        train, train_counts, live = phase_train(torch, np, tmp, ops, cfg4)
        log(f"launches on the trainer's save and restore: {train_counts}")
        t4c = time.perf_counter()
        elastic, elastic_counts = phase_elastic_restore(torch, ops, cfg4, live, train)
        phase_s["phase 4c"] = time.perf_counter() - t4c
        mark[0] += phase_s["phase 4c"]         # phase 4's seconds leave 4c out
        log(f"phase 4c: {phase_s['phase 4c']:.1f} s")
        t4d = time.perf_counter()
        remat = phase_remat(torch, np, cfg4, live)
        phase_s["phase 4d"] = time.perf_counter() - t4d
        mark[0] += phase_s["phase 4d"]         # phase 4's seconds leave 4d out
        log(f"phase 4d: {phase_s['phase 4d']:.1f} s")
        t4e = time.perf_counter()
        remote, remote_counts = phase_remote(torch, np, ops, cfg4, live, train)
        phase_s["phase 4e"] = time.perf_counter() - t4e
        mark[0] += phase_s["phase 4e"]         # phase 4's seconds leave 4e out
        log(f"phase 4e: {phase_s['phase 4e']:.1f} s")
        t4b = time.perf_counter()
        tuned, tuned_counts = phase_tuned_save(torch, np, tmp, ops, cfg4, live, train)
        del live
        phase_s["phase 4b"] = time.perf_counter() - t4b
        mark[0] += phase_s["phase 4b"]         # phase 4's seconds leave 4b out
        log(f"launches on the tuned save and restore: {tuned_counts}")
        log(f"phase 4b: {phase_s['phase 4b']:.1f} s")
        torch.cuda.empty_cache()               # room for the drill's processes
        train["drill"] = phase_drill(torch, tmp)
        done("phase 4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the restore undoes every delta of the save: one undelta a basket
    assert counts["undelta"] == counts["delta"] > 0, counts
    counts = {k: counts[k] + zz_counts[k] + train_counts[k] + elastic_counts[k]
              + remote_counts[k] + tuned_counts[k] for k in counts}
    for name in ops.PRECOND_KERNELS:
        assert counts[name] > 0, f"{name} never launched on the checkpoint path"
    import torch.distributed as dist
    try:
        serve, serve_counts = phase_serve(torch, ops)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for name in ("qpack", "qunpack"):
        assert serve_counts[name] > 0, f"{name} never launched on the serve path"
        counts[name] = serve_counts[name]
    done("phase 5")
    dense, dense_counts = phase_dense_serve(torch, ops)
    log(f"launches on the dense serve path: {dense_counts}")
    done("phase 6")
    families = {}
    for phase, arch in (("phase 7", "jamba-v0.1-52b"),
                        ("phase 8", "llama4-scout-17b-a16e")):
        families[arch], fam_counts = phase_family_serve(torch, ops, phase, arch)
        log(f"launches on the {arch} serve path: {fam_counts}")
        done(phase)
    checks = phase_family_checks(torch)
    done("phase 9")
    dtmp = tempfile.mkdtemp(prefix="chip_smoke-dryrun-")
    try:
        dryrun = phase_dryrun(torch, dtmp, train)
    finally:
        shutil.rmtree(dtmp, ignore_errors=True)
    done("phase 10")
    for row in rows:
        row["launches"] = counts[row["name"]]
    log(json.dumps({"phase3_events": events, "phase3b_zigzag_save": zigzag,
                    "phase4_train_qwen3_8b_depth1": train,
                    "phase4b_tuned_save": tuned, "phase4c_elastic_restore": elastic,
                    "phase4d_remat_and_variants": remat,
                    "phase4e_remote_shards_and_prefetch_restore": remote,
                    "precond_share": share, "phase5_serve_rwkv6_1_6b": serve,
                    "phase6_serve_qwen3_8b": dense,
                    "phase7_serve_jamba_v0_1_52b_1_group": families["jamba-v0.1-52b"],
                    "phase8_serve_llama4_scout_depth4": families["llama4-scout-17b-a16e"],
                    "phase9_checks": checks, "phase10_dryrun": dryrun, "phase_s": phase_s,
                    "card": smi, "wall_s": time.perf_counter() - t_start}))
    stop_multiprocessing_helpers()
    left = live_descendants(wait_s=10.0)
    if left:
        for pid, cmd in left:
            log(f"still running: pid {pid}: {cmd}")
        return 1
    import multiprocessing
    kids, threads = multiprocessing.active_children(), _service_threads()
    if kids or threads:
        log(f"still running: children {kids}, service threads {threads}")
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": CARDS_USED}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_multiprocessing_helpers()
    sys.exit(code)
