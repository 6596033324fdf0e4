"""Readings for the limits of a cell's check, on the chip.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--control N] [--fault half_batch]

In one process, for each seed: the cell's set-up and a short window of
its load, then the numbers its check compares (the program against the
plain reference), and for the first ``--control`` seeds the same numbers
with the reference's float8 control in the program's place; with ``--fault`` a
fault of ``faults.py`` is planted in the program first.  One JSON line a
seed.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import contextlib
    import torch
    from portbench import faults, harness
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell, wl, _ = harness.make_cell(args.workload, seed, args.seconds, False,
                                        args.device)
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        plant = faults.planted(args.fault) if args.fault else contextlib.nullcontext()
        with plant:
            out = harness.driver(wl["driver"]).run(cell)
        line = {"seed": seed, "setup_s": out.window.t0 - t0, "e2e": out.e2e,
                "attempted": out.attempted, "failed": out.failed,
                "peak_bytes": torch.cuda.max_memory_allocated() if args.device == "cuda" else 0}
        out.release()
        t1 = time.perf_counter()
        line["program"] = out.check()
        line["check_s"] = time.perf_counter() - t1
        if n < args.control:
            line["control"] = out.control()
        line["fault"] = args.fault or None
        print(json.dumps(line), flush=True)
        del out, cell
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
