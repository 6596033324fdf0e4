"""Serve batched requests against a trained checkpoint (continuous
batching) on the PyTorch port — the paper's decompression-speed-bound
"analysis" side.

The port's counterpart of ``examples/serve_lm.py``: trains the reduced
qwen3-8b through ``repro_torch.launch.train`` if the workdir holds no
checkpoint, restores ``{params, opt, step, err}`` into the meta template
of ``abstract_train_state``, casts the float32 params to bf16 and serves
12 requests at temperature 0.7 through ``ServeEngine``.  On the card by
default; ``--device cpu`` runs on the CPU.

Run:  python examples/serve_lm_torch.py [--steps 60] [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import abstract_train_state  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_serve_lm"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def restore_params(mgr: CheckpointManager, model, device):
    """The latest checkpoint's train state restored onto ``device``, and
    its params with every float32 leaf cast to bf16."""
    state = abstract_train_state(model)
    tmpl = {"params": state.params, "opt": state.opt, "step": state.step,
            "err": state.err}
    tree, meta = mgr.restore(template=tmpl, device=device)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(torch.bfloat16) if node.dtype == torch.float32 else node

    return tree, meta, cast(tree["params"])


def main(argv=None) -> int:
    a = parse_args(argv)
    cfg = reduced(get_config("qwen3-8b"))
    model = Model(cfg)
    mgr = CheckpointManager(os.path.join(a.workdir, "ckpt"))
    if mgr.latest_step() is None:
        print(f"no checkpoint — training {a.steps} quick steps first...")
        code = train_main(["--arch", "qwen3-8b", "--reduced",
                           "--steps", str(a.steps), "--batch", "4",
                           "--seq-len", "64", "--ckpt-every", str(a.steps),
                           "--workdir", a.workdir, "--device", a.device])
        if code:
            return code
    tree, meta, params = restore_params(mgr, model, torch.device(a.device))
    print(f"restored step {int(tree['step'])} "
          f"(cursor: {meta.get('data_cursor')})")

    eng = ServeEngine(model, params, batch_slots=4, max_len=96, eos_id=-1,
                      temperature=0.7, seed=1)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    for _ in range(12):
        eng.submit(rng.integers(2, cfg.vocab, 8), max_new=12)
    out = eng.run()
    dt = time.monotonic() - t0
    tok = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s)")
    for rid in sorted(out)[:3]:
        print(f"  req {rid}: {out[rid].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
