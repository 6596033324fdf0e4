"""Training driver, the port of ``repro/launch/train.py``.

Config registry -> model -> token pipeline (compressed BasketFile shards)
-> train step -> checkpoint manager (async, atomic, compressed, its
preconditioners run by the port's kernels on the card) -> resume.  The
flags are the reference's, plus ``--device`` (default ``cuda``; ``cpu``
only when asked).  Weights are random, drawn on the device from a
generator seeded with 0; the shards are synthetic tokens from numpy's
generator, as in the reference.  Every arch trains; an encoder-decoder
arch gets the reference's stub ``frames`` (0.01 everywhere, min(S, 64)
of them), a VLM its stub ``patches``.

A checkpoint of either package resumes in either driver: the state is
saved under the reference's tree paths (``params``, ``opt.{m,v,count}``,
``step``, ``err``) with the pipeline's cursor in its metadata.  The save
compresses baskets on every core, where the reference's driver compresses
them one at a time; the bytes are the same.

Fault-tolerance drill: ``--simulate-preempt N`` waits for the save, closes
the pipeline and exits with 17 after N steps; running the same command
again resumes from the latest checkpoint, cursor included.  The pipeline's
I/O engine is closed on every way out.

Usage (on the card; ``--reduced --device cpu`` on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --steps 200 --workdir runs/train1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import _resolve_device
from ..configs import get_config, list_archs, reduced
from ..data import TokenPipeline, write_token_shards
from ..io import cpu_count
from ..models import Model
from ..train import init_train_state, make_train_step
from ..train.step import TrainState, abstract_train_state

PREEMPTED = 17


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` leaves behind: the exit code, the live state, the
    wall seconds of each step taken (batch, step and, when the step is
    logged, its metrics on the host), and the last save's statistics."""
    code: int
    state: TrainState
    step_seconds: list
    save_stats: Optional[dict]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale config (same structure)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--n-shards", type=int, default=4)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--simulate-preempt", type=int, default=0,
                    help="exit(17) after N steps (fault-tolerance drill)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(cfg, model) for ``args``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return cfg, Model(cfg)


def build_batch(cfg, raw, accum: int, device):
    """numpy pipeline batch -> model batch on ``device`` (adds the frames
    and image prefix stubs)."""
    b = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    B, S = b["tokens"].shape
    if cfg.is_encdec:
        b["frames"] = torch.full((B, min(S, 64), cfg.d_model), 0.01,
                                 dtype=torch.float32, device=device)
    if cfg.n_img_tokens:
        b["patches"] = torch.full((B, cfg.n_img_tokens, cfg.d_model), 0.01,
                                  dtype=torch.float32, device=device)
    if accum > 1:
        b = {k: v.reshape((accum, B // accum) + tuple(v.shape[1:]))
             for k, v in b.items()}
    return b


def _tree(state: TrainState) -> dict:
    return {"params": state.params, "opt": state.opt, "step": state.step,
            "err": state.err}


def _shards(cfg, args) -> list[str]:
    """The shard paths, written once per workdir."""
    shard_dir = os.path.join(args.workdir, "data")
    shards = [os.path.join(shard_dir, f"shard-{i:03d}.bskt")
              for i in range(args.n_shards)]
    if not all(os.path.exists(p) for p in shards):
        os.makedirs(shard_dir, exist_ok=True)
        write_token_shards(
            shards, vocab=cfg.vocab,
            tokens_per_shard=max((args.seq_len + 1) * args.batch * 32, 20000))
    return shards


def run(cfg, model, args) -> TrainRun:
    """Train ``model`` as ``args`` say, resuming from the workdir's latest
    checkpoint if there is one."""
    device = _resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    pipe = TokenPipeline(_shards(cfg, args), batch=args.batch,
                         seq_len=args.seq_len, host_id=args.host_id,
                         n_hosts=args.n_hosts)
    try:
        return _train(cfg, model, args, device, pipe)
    finally:
        pipe.close()


def _train(cfg, model, args, device, pipe) -> TrainRun:
    mgr = CheckpointManager(os.path.join(args.workdir, "ckpt"), keep=2,
                            workers=cpu_count())
    start_step = 0
    if mgr.latest_step() is not None:
        tmpl = _tree(abstract_train_state(model,
                                          compress_grads=args.compress_grads))
        tree, meta = mgr.restore(template=tmpl, device=device)
        state = TrainState(params=tree["params"], opt=tree["opt"],
                           step=tree["step"], err=tree["err"])
        if "data_cursor" in meta:
            pipe.load_state_dict(meta["data_cursor"])
        start_step = int(tree["step"])
        print(f"resumed from step {start_step} (cursor {meta.get('data_cursor')})")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_train_state(model, gen, compress_grads=args.compress_grads)

    step_fn = make_train_step(
        model, peak_lr=args.lr, warmup=max(args.steps // 20, 5),
        total_steps=args.steps, accum=args.accum,
        compress_grads=args.compress_grads)

    log_path = os.path.join(args.workdir, "train_log.jsonl")
    t0 = time.monotonic()
    toks_done = 0
    step_seconds = []
    with open(log_path, "a") as logf:
        for i in range(start_step, args.steps):
            ts = time.perf_counter()
            batch = build_batch(cfg, next(pipe), args.accum, device)
            state, metrics = step_fn(state, batch)
            toks_done += args.batch * args.seq_len
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1,
                         tok_per_s=toks_done / (time.monotonic() - t0))
                logf.write(json.dumps(m) + "\n")
                logf.flush()
                print(f"step {i+1:5d} loss={m['loss']:.4f} "
                      f"acc={m['accuracy']:.3f} {m['tok_per_s']:.0f} tok/s")
            step_seconds.append(time.perf_counter() - ts)
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                mgr.save(i + 1, _tree(state),
                         extra_meta={"data_cursor": pipe.state_dict(),
                                     "arch": cfg.name})
            if args.simulate_preempt and (i + 1) >= args.simulate_preempt \
                    and i + 1 < args.steps:
                stats = mgr.wait()
                print(f"simulated preemption at step {i+1}", flush=True)
                return TrainRun(PREEMPTED, state, step_seconds, stats)
    stats = mgr.wait()
    if stats:
        print(f"final ckpt: {stats['branches']} branches "
              f"ratio={stats['raw']/max(stats['comp'],1):.2f}x")
    return TrainRun(0, state, step_seconds, stats)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, model = build(args)
    return run(cfg, model, args).code


if __name__ == "__main__":
    raise SystemExit(main())
