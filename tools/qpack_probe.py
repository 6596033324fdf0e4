#!/usr/bin/env python3
"""Probe the qpack kernel on one GPU.

Run from the repository root:

    python3 tools/qpack_probe.py [--other NAME=DIR ...] [--out artifacts/qpack_probe.json]

It compiles ``src/repro_torch/kernels/csrc/qpack.cu`` and, for each
``--other NAME=DIR``, the ``qpack.cu`` of another checkout (``parent``: the
parent commit's), writes each build's SASS instruction counts (by
``cuobjdump``), holds every build bit for bit against the plain version
(``kernels/ref.py``) on random, zero, tie and (but the parent's) non-finite
rows, and times them on the device (``torch.profiler`` kernel time a call):

- this source over R from 4 to 32768 at C = 512, 1024 and 2048, and at
  long rows (chunks read again from L2), beside the bound;
- at the serve path's and the prefill_32k shapes, every build in turns
  (first to last, then back), also by CUDA events over back-to-back
  launches, beside qunpack at the decode shape.

It exits non-zero without a GPU, and on any difference from the plain
version.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def build(name: str, csrc: str, tmp: str):
    """Start nvcc on ``csrc``'s qpack.cu; returns (library path, process)."""
    d = os.path.join(tmp, name.replace(" ", "_"))
    os.makedirs(d)
    for f in ("common.cuh", "errors.cu", "qpack.cu"):
        shutil.copy(os.path.join(csrc, f), d)
    lib = os.path.join(d, "libqpack.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.Popen(
        [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         "-Xptxas", "-v", "-o", lib, os.path.join(d, "qpack.cu"),
         os.path.join(d, "errors.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def opcodes(lib: str, dump: str) -> dict:
    """{kernel: {opcode: count}} of the qpack kernels' SASS in ``lib``
    (``cuobjdump -sass``), the listing written to ``dump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    with open(dump, "w") as f:
        f.write(text)
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s+Function : (\S+)", line)
        if head:
            name = head.group(1) if "qpack_kernel" in head.group(1) else None
            if name:
                name = "bf16" if "bfloat16" in name else "f32"
                counts[name] = {}
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and op:
            key = op.group(1).split(".")[0]
            counts[name][key] = counts[name].get(key, 0) + 1
    return counts


def launcher(lib: str):
    fn = ctypes.CDLL(lib).rt_qpack
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_float, P]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qpack_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="a checkout whose qpack.cu is timed beside")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts", "qpack_probe.json"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(prefix="qpack_probe-")
    try:
        jobs = {"as built": build("as built", CSRC, tmp)}
        for other in args.other:
            name, path = other.split("=", 1)
            jobs[name] = build(name, os.path.join(
                path, "src", "repro_torch", "kernels", "csrc"), tmp)
        fns, ptxas, sass = {}, {}, {}
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        for n, (lib, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(out)
                raise SystemExit(f"nvcc failed on {n!r}")
            ptxas[n] = [ln for ln in out.splitlines()
                        if "qpack_kernel" in ln or "registers" in ln or "spill" in ln]
            fns[n] = launcher(lib)
            sass[n] = opcodes(lib, os.path.join(os.path.dirname(args.out),
                                                f"qpack_sass_{n.replace(' ', '_')}.txt"))
        print("\n".join(ptxas["as built"]), flush=True)
        for n, counts in sass.items():
            for fn_name, ops in counts.items():
                top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
                print(f"sass {n} {fn_name}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in top), flush=True)
        result = {"card": smi, "torch": torch.__version__, "ptxas": ptxas, "sass": sass}
        unpack = ctypes.CDLL(jobs["as built"][0]).rt_qunpack
        unpack.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        g = torch.Generator(device="cuda").manual_seed(11)

        def inputs(rows, cols, dtype, kind):
            x = torch.randn((rows, cols), generator=g, device="cuda") * 3
            if kind == "zeros":
                x[::3] = 0.0
            elif kind == "ties":
                e = torch.randint(-6, 6, (rows, 1), generator=g, device="cuda").float()
                k = torch.randint(-127, 127, (rows, cols), generator=g, device="cuda")
                x = (k.float() + 0.5) * torch.exp2(e)
                x[:, 0] = 127.0 * torch.exp2(e[:, 0])
            elif kind == "nonfinite":
                r = torch.arange(rows, device="cuda")
                c = torch.randint(0, cols, (rows,), generator=g, device="cuda")
                x[r[0::4], c[0::4]] = float("nan")
                x[r[1::4], c[1::4]] = float("inf")
                x[r[2::4], c[2::4]] = -float("inf")
            return x.to(dtype)

        def run(fn, x, zs=1.0, q=None, s=None):
            rows, cols = x.shape
            q = torch.empty((rows, cols), dtype=torch.int8, device="cuda") if q is None else q
            s = torch.empty((rows, 1), device="cuda") if s is None else s
            code = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols,
                      0 if x.dtype == torch.float32 else 1, zs,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"rt_qpack failed: CUDA error {code}")
            return q, s

        def same(got, want):
            return all(a.shape == b.shape and torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for a, b in zip(got, want))

        def device_us(fn, x, calls=50):
            q, s = run(fn, x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run(fn, x, q=q, s=s)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            return sum(e.self_device_time_total for e in evs) / calls

        def events_ms(fn, x, reps=100):
            q, s = run(fn, x)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                run(fn, x, q=q, s=s)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps

        # every build bit-equal to the plain version
        checks, failures = 0, []
        shapes = [(r, c) for r in (4, 133, 4096) for c in (7, 2047, 2048, 7168)]
        shapes += [(3, 4097), (3, 65537), (2, 131073)]
        for n, fn in fns.items():
            for rows, cols in shapes:
                for dtype in (torch.float32, torch.bfloat16):
                    for kind in ("random", "zeros", "ties", "nonfinite"):
                        if kind == "nonfinite" and n == "parent":  # its fault
                            continue
                        x = inputs(rows, cols, dtype, kind)
                        for zs in (0.0, 1.0):
                            got, want = run(fn, x, zs), ref.qpack(x, zs)
                            torch.cuda.synchronize()
                            checks += 1
                            if not same(got, want):
                                bad = (got[0] != want[0]).nonzero()[:4].tolist()
                                wrong = (got[1].view(torch.int32) != want[1].view(torch.int32))
                                failures.append(
                                    f"{n!r} {rows}x{cols} {dtype} {kind} "
                                    f"zero_scale={zs}: q differs at {bad}, scale bits at "
                                    f"{wrong.nonzero()[:4, 0].tolist()}: "
                                    f"{got[1][wrong][:4].tolist()} vs {want[1][wrong][:4].tolist()}")
                                print(failures[-1], flush=True)
        print(f"{checks - len(failures)} of {checks} runs bit-equal to the plain "
              "version", flush=True)
        result["checks"], result["failures"] = checks, failures

        # this source over R, beside the bound
        sweep = []
        for cols, dtype in ((512, torch.float32), (1024, torch.float32),
                            (2048, torch.float32), (2048, torch.bfloat16)):
            for rows in (4, 264, 528, 1056, 2112, 4224, 8448, 16896, 32768):
                x = inputs(rows, cols, dtype, "random")
                row = {"rows": rows, "cols": cols, "dtype": str(dtype)[6:],
                       "device_us": min(device_us(fns["as built"], x) for _ in range(2)),
                       "bound_us": (rows * cols * (x.element_size() + 1) + 4 * rows)
                       / 3.35e12 * 1e6}
                sweep.append(row)
                print(f"rows: {rows:6d}x{cols:<5d} {row['dtype']:9s} {row['device_us']:8.2f} us"
                      f"  bound {row['bound_us']:8.2f} us", flush=True)
        result["rows"] = sweep

        # long rows: every chunk but the last read again from L2
        long_rows = []
        for rows, cols, dtype in ((132, 32768, torch.float32), (264, 65536, torch.float32),
                                  (1056, 65536, torch.float32), (264, 131072, torch.bfloat16),
                                  (1056, 131072, torch.bfloat16), (264, 262144, torch.float32)):
            x = inputs(rows, cols, dtype, "random")
            row = {"rows": rows, "cols": cols, "dtype": str(dtype)[6:],
                   "device_us": device_us(fns["as built"], x, 20),
                   "bound_us": rows * cols * (x.element_size() + 1) / 3.35e12 * 1e6}
            long_rows.append(row)
            print(f"long rows: {rows:5d}x{cols:<7d} {row['dtype']:9s} "
                  f"{row['device_us']:9.2f} us  bound {row['bound_us']:8.2f} us", flush=True)
        result["long_rows"] = long_rows

        # every build in turns, and qunpack beside
        order = list(fns) + list(fns)[::-1]
        pairs = []
        for rows, cols, dtype in ((32768, 2048, torch.float32), (32768, 2048, torch.bfloat16),
                                  (256, 2048, torch.float32), (4, 2048, torch.float32),
                                  (4, 512, torch.float32)):
            x = inputs(rows, cols, dtype, "random")
            dev = [device_us(fns[n], x) for n in order]
            ev = [events_ms(fns[n], x) for n in order]
            row = {"rows": rows, "cols": cols, "dtype": str(dtype)[6:],
                   "bound_us": (rows * cols * (x.element_size() + 1) + 4 * rows)
                   / 3.35e12 * 1e6}
            for n in dict.fromkeys(order):
                row[n] = {"device_us": [d for d, m in zip(dev, order) if m == n],
                          "events_ms": [e for e, m in zip(ev, order) if m == n]}
            pairs.append(row)
            print(f"compare {rows:6d}x{cols} {row['dtype']:9s} bound {row['bound_us']:.2f} us: "
                  + "; ".join(f"{n} {min(row[n]['device_us']):.2f} us "
                              f"{min(row[n]['events_ms']):.4f} ms" for n in dict.fromkeys(order)),
                  flush=True)
        q, s = run(fns["as built"], inputs(4, 2048, torch.float32, "random"))
        out = torch.empty((4, 2048), dtype=torch.bfloat16, device="cuda")

        def qunpack_call(fn=None, x=None, q=q, s=s, out=out):
            unpack(q.data_ptr(), s.data_ptr(), out.data_ptr(), 1, 4, 2048, 1,
                   torch.cuda.current_stream().cuda_stream)
            return q, s
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                qunpack_call()
            torch.cuda.synchronize()
        qu = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 50
        print(f"compare qunpack 4x2048 bf16 out: {qu:.2f} us", flush=True)
        result["compare"], result["qunpack_decode_us"] = pairs, qu
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"qpack_probe: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
