"""Train a small LM end to end on the PyTorch port: compressed data
pipeline -> train step -> compressed async checkpoints -> resume.

The port's counterpart of ``examples/train_lm.py``: the same launcher
flags, driven through ``repro_torch.launch.train``, on the card by
default (``--device cpu`` runs the plain versions of the kernels).

Run:  python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    # rwkv6 reduced is the fastest family a step; --reduced shrinks the
    # widths and keeps every subsystem in play
    return train_main([
        "--arch", "rwkv6-1.6b", "--reduced",
        "--steps", str(a.steps),
        "--batch", "8", "--seq-len", "128",
        "--ckpt-every", "100", "--log-every", "20",
        "--workdir", a.workdir, "--device", a.device,
    ])


if __name__ == "__main__":
    raise SystemExit(main())
