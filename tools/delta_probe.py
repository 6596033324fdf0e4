#!/usr/bin/env python3
"""Probe the forward delta kernel on one GPU, beside another checkout's.

Run from the repository root:

    python3 tools/delta_probe.py [--other NAME=DIR ...] [--out artifacts/delta_probe.json]

It compiles ``src/repro_torch/kernels/csrc/delta.cu`` and, for each
``--other NAME=DIR``, the ``delta.cu`` of another checkout (``parent``: the
parent commit's), each with ``-Xptxas -v`` (registers and spills printed),
holds every build's ``rt_delta`` byte for byte against the plain version
(``kernels/ref.py``) at I = 1, 2, 4, 8 with tails and pointers off a 16-byte
boundary, and times every build in turns (first to last, then back) at
1 MiB (the main path's basket, I = 8) for every I, the same with a
3-byte tail, and 100 MB with I = 1, 2, 4 and 8: CUDA events over
back-to-back launches, and ``torch.profiler`` device microseconds (the
median of the turns) and device operations a call, beside the bound
(bytes read and written once at 3.35 TB/s), ``torch.diff`` and a
device-to-device copy of the same bytes.  This checkout's ``rt_zigzag``
(``zigzag.cu``: the same vector path without the neighbour) is timed in
the same turns, as build ``this/zigzag``.

It exits non-zero without a GPU, and on any difference from the plain
version.
"""

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
CASES = [(1, 1 << 20, "1 MiB"), (2, 1 << 20, "1 MiB"), (4, 1 << 20, "1 MiB"),
         (8, 1 << 20, "1 MiB"), (8, (1 << 20) + 3, "1 MiB + tail"),
         (1, 100_000_000, "100 MB"), (2, 100_000_000, "100 MB"),
         (4, 100_000_000, "100 MB"), (8, 100_000_000, "100 MB")]


def build(name: str, csrc: str, tmp: str, sources=("delta.cu",)):
    """Start nvcc on ``csrc``'s ``sources``; returns (library path, process)."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in glob.glob(os.path.join(csrc, "*.cuh")) + [
            os.path.join(csrc, f) for f in (*sources, "errors.cu")]:
        shutil.copy(f, d)
    lib = os.path.join(d, "libdelta.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.Popen(
        [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         "-Xptxas", "-v", "-o", lib,
         *(os.path.join(d, f) for f in (*sources, "errors.cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def launcher(lib: str, symbol: str = "rt_delta"):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ptxas_summary(out: str) -> list:
    """(function, its ptxas registers/stack lines) of the delta and zigzag
    kernels in nvcc's -Xptxas -v output."""
    rows, fn = [], None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("delta_kernel" in fn or "zigzag_kernel" in fn) and \
                "undelta" not in fn and ("registers" in line or "stack frame" in line):
            rows.append((fn, line.strip()))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("delta_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, device_ops_best, host_us
    from repro_torch.kernels import ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR of another checkout")
    ap.add_argument("--out", default=os.path.join("artifacts", "delta_probe.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = [("this", CSRC)] + [
        (o.split("=", 1)[0], os.path.join(o.split("=", 1)[1], "src", "repro_torch",
                                          "kernels", "csrc")) for o in args.other]
    tmp = tempfile.mkdtemp(prefix="delta_probe-")
    try:
        started = [(name, *build(name, csrc, tmp, ("delta.cu", "zigzag.cu")
                                 if name == "this" else ("delta.cu",)))
                   for name, csrc in trees]
        fns = {}
        for name, lib, proc in started:
            out, _ = proc.communicate()
            if proc.returncode:
                print(out)
                raise SystemExit(f"{name}: nvcc failed")
            print(f"--- {name}: ptxas (delta and zigzag kernels)")
            for fn, line in ptxas_summary(out):
                print(f"    {fn}: {line}")
            fns[name] = launcher(lib)
            if name == "this":
                fns["this/zigzag"] = launcher(lib, "rt_zigzag")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    g = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, x, out, itemsize):
        n, tail = divmod(x.numel(), itemsize)
        code = fn(x.data_ptr(), out.data_ptr(), n, itemsize, tail, stream)
        if code:
            raise RuntimeError(f"rt_delta failed: CUDA error {code}")

    checked = 0
    for itemsize in (1, 2, 4, 8):
        v = 16 // itemsize
        for nbytes in sorted({max(0, (c * v + d) * itemsize + t)
                              for c in (0, 1, 17, 256, 4096, 263 * 1024 + 1)
                              for d in (-1, 1) for t in (0, itemsize - 1)}):
            pad = torch.randint(0, 256, (nbytes + 32,), dtype=torch.uint8,
                                device="cuda", generator=g)
            base = (-pad.data_ptr()) % 16
            for off in (0, itemsize):
                x = pad[base + off:base + off + nbytes]
                want = ref.delta(x, itemsize)
                for name, fn in fns.items():
                    if name == "this/zigzag":
                        continue
                    out = torch.empty_like(x)
                    call(fn, x, out, itemsize)
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise SystemExit(f"{name}: rt_delta I={itemsize} {nbytes} "
                                         f"bytes, offset {off}: differs")
                    checked += 1
    print(f"{checked} runs byte-equal to ref.delta", flush=True)

    rows = []
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    print("case                 I  build      events_ms  host_us  device_us  "
          "ops/call  bound_ms  diff_ms  copy_ms")
    for itemsize, nbytes, label in CASES:
        x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                          generator=g)
        out = torch.empty_like(x)
        large = nbytes > (1 << 24)
        reps, calls = (20, 200) if large else (200, 2000)
        order = list(fns) + list(fns)[::-1]
        per = {name: [] for name in fns}
        dev = {name: [] for name in fns}
        for name in order:
            fn = fns[name]
            per[name].append(cuda_ms(lambda f=fn: call(f, x, out, itemsize),
                                     reps, rounds=3))
            dev[name].append(device_ops_best(lambda f=fn: call(f, x, out, itemsize)))
        v = x[:nbytes - nbytes % itemsize].view(signed[itemsize])
        zero = v[:1] * 0
        diff_ms = cuda_ms(lambda: torch.diff(v, prepend=zero), reps, rounds=3)
        copy_ms = cuda_ms(lambda: out.copy_(x), reps, rounds=3)
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        for name, fn in fns.items():
            ms = min(per[name])
            h = host_us(lambda f=fn: call(f, x, out, itemsize), calls=calls)
            d = sorted(t[0] for t in dev[name])[len(dev[name]) // 2]
            _, ops, names = max(dev[name], key=lambda t: t[1])
            rows.append({"case": label, "itemsize": itemsize, "bytes": nbytes,
                         "build": name, "events_ms": ms, "events_ms_runs": per[name],
                         "host_us": h, "device_us": d,
                         "device_us_runs": [t[0] for t in dev[name]],
                         "device_ops_per_call": ops,
                         "ops": names, "bound_ms": bound_ms, "diff_ms": diff_ms,
                         "copy_ms": copy_ms})
            print(f"{label:18s} {itemsize:3d}  {name:9s} {ms:9.4f}  {h:7.2f}  "
                  f"{d:9.2f}  {ops:8g}  {bound_ms:8.4f}  {diff_ms:7.4f}  "
                  f"{copy_ms:7.4f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
