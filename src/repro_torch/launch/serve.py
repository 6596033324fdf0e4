"""Serving entry point: build a model, serve batched requests.

The port of ``repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` only when asked).  Weights are
random, drawn on the device from a generator seeded with 0 and cast to
bf16, as the reference's are; prompts come from numpy's generator seeded
with 0.  Every arch builds.  The dense attention archs (qwen3-8b, the
default), paligemma-3b without its image prefix, rwkv6-1.6b, llama4 and
jamba serve.  seamless-m4t-medium prints the reference's note and then
fails as the reference does: the engine passes no ``frames``, so its
prefill raises ``KeyError: 'frames'``.  ``--ckpt-dir`` restores the latest
checkpoint there onto the device and then exits, as the reference does: a
directory without one raises ``FileNotFoundError``, a corrupt one the
checksum error; checkpoint serving lives in ``examples/serve_lm_torch.py``.  The int8 compressed tensor-parallel
reduction (RWKV only) is switched on as in the reference:
``models.rwkv.PERF_FLAGS["compressed_tp"]`` plus an active
``parallel.activation_context``.

Usage (on the card; ``--reduced --device cpu`` on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --requests 8 --prompt-len 64 --max-new 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import _resolve_device
from ..configs import get_config, list_archs, reduced
from ..models import Model
from ..serve import ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args, cfg=None):
    """(cfg, model, params) for ``args``: bf16 weights on the device.
    ``cfg`` replaces ``args.arch``'s config (a depth-cut one, say)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    if cfg.is_encdec or cfg.n_img_tokens:
        print(f"note: {cfg.name} serving uses the LM decoder path with "
              "stub modality inputs omitted")
    model = Model(cfg)
    device = _resolve_device(args.device)
    if args.ckpt_dir:
        CheckpointManager(args.ckpt_dir).restore(device=device)
        raise SystemExit("checkpoint serving wired via "
                         "examples/serve_lm_torch.py")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, model, model.init(gen, dtype=torch.bfloat16)


def serve(model, params, args, vocab: int):
    """Submit ``args.requests`` random prompts and drain them.  Returns
    ({req_id: tokens}, wall seconds)."""
    eng = ServeEngine(model, params, batch_slots=args.slots,
                      max_len=args.max_len, eos_id=-1,
                      temperature=args.temperature)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    for _ in range(args.requests):
        eng.submit(rng.integers(2, vocab, args.prompt_len), args.max_new)
    out = eng.run()
    return out, time.monotonic() - t0


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, model, params = build(args)
    out, dt = serve(model, params, args, cfg.vocab)
    n_tok = sum(len(v) for v in out.values())
    print(f"{len(out)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s, slots={args.slots})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
