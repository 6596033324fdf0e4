"""The trainer's loop, as ``repro_torch.launch.train`` composes it.

Set-up: token shards written from the seed under ``TMPDIR`` (a Zipf
stream of ids 2..V-1, the trainer's synthetic corpus, through the
program's ``BasketWriter``), a ``TokenPipeline`` over them, the float32
master weights drawn from the seed on the device, AdamW's state and the
error-feedback residual, the step of ``make_train_step``, and the first
``check_steps`` steps through the window's own call and feed (rows all
differ).  Their losses, the first gradient as the optimizer got it (its
first moment over 1 - b1) and each leaf's change after the last of them
are kept for the check; they also warm every shape the window runs.

Window: ``next(pipe)``, ``build_batch`` and a step, until the seconds are
up; the window ends in a synchronise.

Check: the plain reference (``reference/train.py``) takes the same seeded
weights and follows the same steps on batches it works out itself from
the shards' tokens and the pipeline's documented order.  Readings: the
worst relative gap of a step's loss; of a leaf's norm of the first
gradient as the optimizer gets it; of a leaf's norm of the change after
the steps, each leaf's gap over the larger of its reference norm and the
median leaf's.  Leaves whose raw reference gradient is under a thousandth
of the median leaf's are left out (round-off alone moves them under Adam).
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from portbench import flops, harness
from portbench.reference.model import flatten
from portbench.reference.train import B1, train_steps
from portbench.weights import seeded_params


def shard_tokens(seed: int, vocab: int, n_shards: int, per_shard: int) -> list:
    """Each shard's tokens: a Zipf(1.3) stream folded onto ids 2..V-1
    (0 pads, 1 ends), as the trainer's synthetic corpus."""
    out = []
    for i in range(n_shards):
        t = np.random.default_rng([seed, i]).zipf(1.3, per_shard).astype(np.int64)
        out.append(((t % (vocab - 2)) + 2).astype(np.int32))
    return out


def expected_batches(tokens: np.ndarray, batch: int, seq_len: int,
                     pipe_seed: int, n: int) -> list:
    """The first ``n`` batches the pipeline serves from its first shard:
    windows of seq_len + 1 tokens in the order of a permutation drawn from
    (seed, epoch 0, file 0), ``batch`` at a time; inputs and next tokens."""
    w = seq_len + 1
    wins = tokens[: (tokens.size // w) * w].reshape(-1, w)
    order = np.random.default_rng((pipe_seed, 0, 0)).permutation(len(wins))
    return [(wins[order[i * batch:(i + 1) * batch], :-1],
             wins[order[i * batch:(i + 1) * batch], 1:]) for i in range(n)]


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared, from two sides' observations."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    raw = ref["raw_grad_norms"]
    med_raw = statistics.median(raw.values())
    counted = [k for k in raw if raw[k] >= 1e-3 * med_raw]

    def gaps(a: dict, b: dict) -> dict:
        med = statistics.median(b[k] for k in counted)
        return {k: abs(a[k] - b[k]) / max(b[k], med) for k in counted}

    grad = gaps(prog["grad_norms"], ref["grad_norms"])
    update = gaps(prog["update_norms"], ref["update_norms"])
    return {"loss_gap": loss, "grad_norm_gap": max(grad.values()),
            "update_norm_gap": max(update.values()),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_update_leaf": max(update, key=update.get)}


def _leaf_norms(tree: dict, scale: float = 1.0) -> dict:
    return {k: float(v.float().norm()) * scale for k, v in flatten(tree).items()}


def run(cell) -> harness.Outcome:
    from repro_torch import train as T
    from repro_torch.core.bfile import BasketWriter
    from repro_torch.core.policy import choose
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.train.optim import adamw_init, tree_map

    cfg, t, dev = cell.cfg, cell.traffic, cell.device
    B, S, accum = t["batch"], t["seq_len"], t["accum"]
    planned = t["planned_steps"]
    sched = {"peak_lr": t["lr"], "warmup": max(planned // 20, 5),
             "total_steps": planned}
    model = Model(cfg)
    tokens = shard_tokens(cell.seed, cfg.vocab, t["n_shards"], (S + 1) * B * 32)
    shard_dir = tempfile.mkdtemp(prefix="portbench-shards-")
    paths = [os.path.join(shard_dir, f"shard-{i:03d}.bskt") for i in range(len(tokens))]
    for p, toks in zip(paths, tokens):
        with BasketWriter(p) as w:
            w.write_branch("tokens", toks, choose("tokens", toks, "analysis"))
    pipe = TokenPipeline(paths, batch=B, seq_len=S, seed=cell.seed)

    def close():
        pipe.close()
        shutil.rmtree(shard_dir, ignore_errors=True)

    try:
        params = seeded_params(model, cell.seed, torch.float32, dev)
        err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=dev),
                       params) if t["compress_grads"] else None
        state = T.TrainState(params=params, opt=adamw_init(params),
                             step=torch.zeros((), dtype=torch.int32, device=dev), err=err)
        del params, err
        step = T.make_train_step(model, accum=accum, compress_grads=t["compress_grads"],
                                 **sched)
        prog = {"loss": []}
        for i in range(t["check_steps"]):
            state, m = step(state, build_batch(cfg, next(pipe), accum, dev))
            prog["loss"].append(float(m["loss"]))
            if i == 0:
                prog["grad_norms"] = _leaf_norms(state.opt["m"], 1.0 / (1 - B1))
        p0 = flatten(seeded_params(model, cell.seed, torch.float32, dev))
        prog["update_norms"] = {k: float((v - p0[k]).norm())
                                for k, v in flatten(state.params).items()}
        del p0, m

        steps, wait_s, losses = 0, 0.0, []
        with cell.window() as win:
            while not win.expired():
                t0 = time.perf_counter()
                with cell.range("pipeline.next"):
                    batch = build_batch(cfg, next(pipe), accum, dev)
                wait_s += time.perf_counter() - t0
                with cell.range("train.step"):
                    state, m = step(state, batch)
                losses.append(m["loss"])
                steps += 1
        failed = sum(not math.isfinite(float(x)) for x in losses)
    except BaseException:
        close()
        raise

    def release():
        close()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    ref_cache: dict = {}

    def reference(fp8: bool) -> dict:
        if fp8 not in ref_cache:
            p0 = seeded_params(model, cell.seed, torch.float32, dev)
            batches = [(torch.from_numpy(x).long().to(dev), torch.from_numpy(y).long().to(dev))
                       for x, y in expected_batches(tokens[0], B, S, cell.seed,
                                                    t["check_steps"])]
            ref_cache[fp8] = train_steps(cell.conf, p0, batches, fp8=fp8,
                                         compress_grads=t["compress_grads"], **sched)
        return ref_cache[fp8]

    tok = steps * B * S
    return harness.Outcome(
        attempted=steps, failed=failed,
        e2e={"train_tok_s": tok / win.seconds},
        records={"kind": "train", "steps": steps, "pipeline_wait_s": wait_s,
                 "train_flops": tok * flops.train_flops_per_token(cell.conf, S)},
        window=win, release=release,
        check=lambda: readings(prog, reference(False)),
        control=lambda: readings(reference(True), reference(False)))
