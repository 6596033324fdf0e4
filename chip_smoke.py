#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's checkpoint path on one GPU and check it.

Run from the repository root:  python3 chip_smoke.py

It builds the preconditioner kernels from ``src/repro_torch/kernels/csrc``,
then runs, failing on the first error:

1. every kernel against its plain PyTorch version on the card (byte-equal),
   over itemsizes 1/2/4/8 and ragged sizes up to a 100 MB basket, with
   times beside the memory-bandwidth bound and one-call PyTorch yardsticks;
2. the ``ckpt_pr2`` golden checkpoint from CUDA tensors, in every staging x workers
   mode;
3. the paper's NanoAOD-like event tree (2M events): bytes from CUDA tensors
   equal bytes from CPU tensors, and the restore is bitwise;
4. a qwen3-8b train state at full width, depth 1 (params f32, bf16 AdamW
   moments): save and restore through ``CheckpointManager``, bitwise.

Launch counters are zeroed just before phase 3 and read after phase 4.  The
second-to-last line is the kernels' JSON record, the last line the device
record.  Without a CUDA device it prints no result and exits 1.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
}
SOURCE = {
    "bitshuffle": "src/repro_torch/kernels/csrc/bitshuffle.cu",
    "bitunshuffle": "src/repro_torch/kernels/csrc/bitshuffle.cu",
    "byteshuffle": "src/repro_torch/kernels/csrc/byteshuffle.cu",
    "byteunshuffle": "src/repro_torch/kernels/csrc/byteshuffle.cu",
    "delta": "src/repro_torch/kernels/csrc/delta.cu",
    "undelta": "src/repro_torch/kernels/csrc/delta.cu",
}
# the largest basket the checkpoint path hands each kernel: qwen3-8b's
# ffn.w_gate at depth 1 (f32: bitshuffle4; its bf16 moments: shuffle2) and
# the event tree's 1 MiB offset baskets (delta8+shuffle8)
MAIN_SHAPES = {
    "bitshuffle": (4, 4096 * 12288 * 4), "bitunshuffle": (4, 4096 * 12288 * 4),
    "byteshuffle": (2, 4096 * 12288 * 2), "byteunshuffle": (2, 4096 * 12288 * 2),
    "delta": (8, 1 << 20), "undelta": (8, 1 << 20),
}


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
    """One PyTorch call computing the same function, where there is one."""
    import torch
    n = x.numel() // itemsize
    if x.numel() % itemsize:
        return None
    if name == "byteshuffle":
        return lambda: x.view(n, itemsize).t().contiguous()
    if name == "byteunshuffle":
        return lambda: x.view(itemsize, n).t().contiguous()
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = x.view(signed[itemsize])
    if name == "undelta":
        return lambda: torch.cumsum(v, 0)
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
                             ("delta", "undelta")):
                assert torch.equal(K[inv](K[fwd](x, itemsize), itemsize), x)
    log(f"phase 1: {checked} kernel runs byte-equal to their plain versions "
        f"(itemsizes 1/2/4/8, element counts {sizes} + 1 MiB + 100 MB + the "
        f"main path's baskets {sorted(set(MAIN_SHAPES.values()))}, ragged tails)")

    rows = []
    log("kernel        itemsize  bytes        ms        GB/s    bound_ms  "
        "plain_ms  library_ms  d2d_copy_ms")
    for label, shapes in (("1 MiB", {k: (v[0], 1 << 20) for k, v in MAIN_SHAPES.items()}),
                          ("main", MAIN_SHAPES)):
        for name, (itemsize, nbytes) in shapes.items():
            kern, plain = pairs[name]
            x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                              device="cuda", generator=g)
            args = _inputs(name, x, itemsize, K)
            reps = 200 if nbytes <= (1 << 20) else 20
            ms = cuda_ms(lambda: kern(*args), reps)
            plain_ms = cuda_ms(lambda: plain(*args), max(reps // 10, 3))
            lib = _library_call(name, x, itemsize)
            lib_ms = cuda_ms(lib, reps) if lib is not None else None
            dst = torch.empty_like(x)
            copy_ms = cuda_ms(lambda: dst.copy_(x), reps)
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
            if label == "main":
                rows.append({"name": name, "route": "cuda",
                             "source": SOURCE[name], "replaces": REPLACES[name],
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": "bytes", "library_ms": lib_ms,
                             "itemsize": itemsize, "bytes": nbytes,
                             "d2d_copy_ms": copy_ms})
    return rows


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
# phase 4: qwen3-8b train state, full width, depth 1
# ---------------------------------------------------------------------------

D, H, KV, DH, FF, VOCAB = 4096, 32, 8, 128, 12288, 151936
# dotted path -> (shape, init): repro's Model.param_specs() for qwen3-8b with
# n_groups = 1, layer leaves stacked on a leading "layers" axis
QWEN3_8B_DEPTH1 = {
    "embed": ((VOCAB, D), "normal"),
    "final_norm.scale": ((D,), "ones"),
    "layers.l0.attn.k_norm": ((1, DH), "ones"),
    "layers.l0.attn.q_norm": ((1, DH), "ones"),
    "layers.l0.attn.wk": ((1, D, KV, DH), "normal"),
    "layers.l0.attn.wo": ((1, H, DH, D), "normal"),
    "layers.l0.attn.wq": ((1, D, H, DH), "normal"),
    "layers.l0.attn.wv": ((1, D, KV, DH), "normal"),
    "layers.l0.ffn.w_down": ((1, FF, D), "normal"),
    "layers.l0.ffn.w_gate": ((1, D, FF), "normal"),
    "layers.l0.ffn.w_up": ((1, D, FF), "normal"),
    "layers.l0.ln1.scale": ((1, D), "ones"),
    "layers.l0.ln2.scale": ((1, D), "ones"),
    "lm_head": ((D, VOCAB), "normal"),
}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def train_state(torch):
    """Params as repro's init_params makes them (normal * 1/sqrt(fan_in),
    fan_in = shape[0]; "ones" constant), bf16 AdamW moments filled with
    small values of a trained state's size, int32 counters."""
    g = torch.Generator(device="cuda").manual_seed(0)
    params, m, v = {}, {}, {}
    for path, (shape, init) in QWEN3_8B_DEPTH1.items():
        if init == "ones":
            p = torch.ones(shape, dtype=torch.float32, device="cuda")
        else:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            p = torch.randn(shape, generator=g, device="cuda") / fan_in ** 0.5
        params[path] = p
        grad = torch.randn(shape, generator=g, device="cuda") * 1e-3
        m[path] = (0.1 * grad).to(torch.bfloat16)
        v[path] = (0.05 * grad * grad).to(torch.bfloat16)
        del grad
    one = torch.ones((), dtype=torch.int32, device="cuda")
    return {"params": _nest(params),
            "opt": {"m": _nest(m), "v": _nest(v), "count": one.clone()},
            "step": one.clone()}


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


def phase_train_state(torch, tmp, workers):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths
    state = train_state(torch)
    flat = _flatten_with_paths(state)
    n_params = sum(t.numel() for k, t in flat.items() if k.startswith("params."))
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    torch.cuda.synchronize()
    log(f"phase 4: qwen3-8b depth 1: {n_params / 1e9:.3f} B params, "
        f"{nbytes / 1e9:.2f} GB on the card; free disk "
        f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB, writes "
        f"{disk_write_gbps(tmp):.3f} GB/s with fsync")
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), workers=workers)
    stage_seconds()
    t0 = time.perf_counter()
    mgr.save(1, state, wait=True)
    save_s = time.perf_counter() - t0
    save_stages = stage_seconds()
    log(f"phase 4: save stages (s): {save_stages}")
    stats = mgr.wait()
    t0 = time.perf_counter()
    restored, _ = mgr.restore(device="cuda", template=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_stages = stage_seconds()
    log(f"phase 4: restore stages (s): {restore_stages}")
    back = _flatten_with_paths(restored)
    for k, t in flat.items():
        assert same_bits(back[k], t), k
    ratio = stats["raw"] / stats["comp"]
    log(f"phase 4: save {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s), "
        f"restore {restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s), "
        f"bitwise equal; ratio {ratio:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    shutil.rmtree(os.path.join(tmp, "ckpt"))
    return {"gb": nbytes / 1e9, "save_s": save_s, "restore_s": restore_s,
            "ratio": ratio, "save_stages_s": save_stages,
            "restore_stages_s": restore_stages}


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
    try:
        rows = phase_kernels(torch, ops.KERNELS, ref)
        phase_golden(torch, np, tmp)
        ops.reset_launch_counts()                      # the main path starts
        events, host_events, _ = phase_events(torch, np, tmp, workers)
        after3 = ops.launch_counts()
        log(f"launches after phase 3: {after3}")
        train = phase_train_state(torch, tmp, workers)
        counts = ops.launch_counts()                   # the main path ends
        log(f"launches after phase 4: {counts}")
        share = precond_share(torch, np, host_events, events["save_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("bitshuffle", "bitunshuffle", "byteshuffle", "byteunshuffle"):
        assert counts[name] - after3[name] > 0, f"{name} not launched in phase 4"
    for name in ops.KERNELS:
        assert counts[name] > 0, f"{name} never launched on the main path"
    for row in rows:
        row["launches"] = counts[row["name"]]
    log(json.dumps({"phase3_events": events, "phase4_qwen3_8b_depth1": train,
                    "precond_share": share, "card": smi,
                    "wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
