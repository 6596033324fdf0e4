"""Batch serving in waves: ``ServeEngine.run`` over one wave of requests
at a time, the next wave submitted when the last has drained (a closed
loop of ``slots`` clients).

The engine decodes every slot at one shared position, so a request
admitted mid-stream would be decoded at another's position: waves keep
every request's position its own.  The traffic repeats a cycle of
``cycle`` waves: its ``slots * cycle`` prompt lengths are the centres of
as many equal bins of ``prompt_len`` (a discrete uniform), wave j taking the j-th length
of each eighth (so each wave spans the range, and its longest prompt,
which sets its padded length, is one of the top eighth's); each wave's
new token counts are spread evenly over ``new_tokens``.  The seed orders
the waves of each cycle and the slots of each wave, and draws the token
ids (uniform on 2..V-1; 0 pads, 1 ends): every seed offers the same
sizes in another order, and the warm-up, one whole cycle, runs every
shape the window will.

Set-up: the bfloat16 weights drawn from the seed on the device, the
engine, and the warm cycle.  Window: waves until the seconds are up; the
last one drains inside it.  The time to first token of a request is from
its wave's submission to the end of the wave's prefill, taken on the
host after the device has finished, through the model the engine is
given (a proxy around the program's model).

Check: a sample drawn from the seed of the requests the window finished,
the longest among them.  The plain reference runs each one's row as the
engine built it (left-padded with 0 to its wave's longest prompt, then
its prompt and its served tokens but the last; the MoE's capacity over
the prompt, as the prefill had it) and reads, at each position that
produced a served token, how far that token's logit lies below the
reference's best: the widest such gap (``token_gap``) and the median
(``token_gap_median``); a cell's workload file says which it compares.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops, harness
from portbench.reference.model import float32_matmuls, token_gap
from portbench.weights import seeded_params


def _spread(lo: int, hi: int, n: int) -> list:
    """The centres of n equal bins over lo..hi, as whole counts."""
    return [lo + ((2 * i + 1) * (hi - lo + 1)) // (2 * n) for i in range(n)]


def cycle_shapes(traffic: dict) -> list:
    """The cycle's waves as lists of (prompt length, new-token count), in
    their unshuffled order."""
    n, w = traffic["slots"], traffic["cycle"]
    lens = _spread(*traffic["prompt_len"], n * w)
    news = _spread(*traffic["new_tokens"], n)
    return [[(lens[j + w * i], news[i]) for i in range(n)] for j in range(w)]


def waves(seed: int, traffic: dict, vocab: int):
    """The wave stream: lists of (prompt tokens, new-token count)."""
    rng = np.random.default_rng([seed, 1])
    shapes = cycle_shapes(traffic)
    while True:
        for j in rng.permutation(len(shapes)):
            lens = [L for L, _ in shapes[j]]
            news = [k for _, k in shapes[j]]
            lens = [lens[i] for i in rng.permutation(len(lens))]
            news = [news[i] for i in rng.permutation(len(news))]
            yield [(rng.integers(2, vocab, size=L).astype(np.int32), k)
                   for L, k in zip(lens, news)]


class _TimedModel:
    """The program's model as the engine is given it: each prefill's end
    is taken on the host clock once the device has finished it."""

    def __init__(self, model, device):
        self._model = model
        self._device = device
        self.prefill_done: list = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, params, batch, max_len):
        out = self._model.prefill(params, batch, max_len)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.prefill_done.append(time.perf_counter())
        return out


def gaps(conf: dict, params: dict, rows: list, control: bool = False) -> dict:
    """How far the served token's logit lies below the reference's best,
    over ``rows`` ((prompt, served tokens, padded prompt length)): the
    widest gap, the median, and the share more than a tenth of a logit
    below.  With ``control`` the token is the float8 reference's choice
    at the same position instead.  The reference is the configuration's
    architecture module's."""
    arch = harness.architecture(conf)
    ref = arch.Reference(conf, params)
    low = arch.Reference(conf, params, fp8=True) if control else None
    every = []
    with float32_matmuls(), torch.no_grad():
        for prompt, served, plen in rows:
            row = np.concatenate([np.zeros(plen - len(prompt), np.int64),
                                  prompt.astype(np.int64), served[:-1].astype(np.int64)])
            toks = torch.from_numpy(row)[None].to(params["embed"].device)
            at = slice(plen - 1, plen - 1 + len(served))
            h, _, _ = ref.hidden(toks, cap_len=plen)
            logits = ref.logits(h[0, at])
            if control:
                hl, _, _ = low.hidden(toks, cap_len=plen)
                chosen = low.logits(hl[0, at]).argmax(-1)
            else:
                chosen = torch.from_numpy(served.astype(np.int64)).to(logits.device)
            every += token_gap(logits, chosen).tolist()
    return {"token_gap": max(every), "token_gap_median": float(np.median(every)),
            "token_miss_share": float(np.mean(np.asarray(every) > 0.1)),
            "tokens": len(every)}


def _failed(attempted: int, done: list) -> int:
    """Of ``attempted`` requests, those whose answer never came, or stopped
    short of its count without the end token (``done``: (prompt, answer,
    padded length, ttft, count asked))."""
    return attempted - sum(bool(len(s) == k or (0 < len(s) < k and s[-1] == 1))
                           for _, s, _, _, k in done)


def run(cell) -> harness.Outcome:
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    cfg, t, dev = cell.cfg, cell.traffic, cell.device
    model = _TimedModel(Model(cfg), dev)
    params = seeded_params(model._model, cell.seed, torch.bfloat16, dev)
    engine = ServeEngine(model, params, batch_slots=t["slots"], max_len=t["max_len"],
                         eos_id=1, temperature=0.0, seed=cell.seed)
    warm = waves(cell.seed + 1, t, cfg.vocab)
    for _ in range(t["cycle"]):
        for p, k in next(warm):
            engine.submit(p, k)
        engine.run()

    stream = waves(cell.seed, t, cfg.vocab)
    done: list = []           # (prompt, served, padded length, ttft s, count asked)
    attempted = 0
    with cell.window() as win:
        while not win.expired():
            wave = next(stream)
            t_sub = time.perf_counter()
            n_pref = len(model.prefill_done)
            with cell.range("serve.wave"):
                ids = [engine.submit(p, k) for p, k in wave]
                answers = engine.run()
            ttft = model.prefill_done[n_pref] - t_sub
            plen = max(len(p) for p, _ in wave)
            attempted += len(wave)
            for rid, (p, k) in zip(ids, wave):
                if rid in answers:
                    done.append((p, answers[rid], plen, ttft, k))

    failed = _failed(attempted, done)
    tokens = sum(len(p) + len(s) for p, s, _, _, _ in done)
    ttfts = [r[3] for r in done]
    rng = np.random.default_rng([cell.seed, 2])
    longest = max(range(len(done)), key=lambda i: len(done[i][0]) + len(done[i][1]))
    rest = [i for i in range(len(done)) if i != longest]
    k = min(t["check_requests"] - 1, len(rest))
    sample = [longest] + [int(i) for i in rng.choice(rest, size=k, replace=False)]
    rows = [done[i][:3] for i in sample]

    def release():
        engine.cache = None
        engine.slots = []
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    return harness.Outcome(
        attempted=attempted, failed=failed,
        e2e={"serve_tok_s": tokens / win.seconds,
             "ttft_p95_ms": float(np.percentile(ttfts, 95)) * 1e3},
        records={"kind": "serve", "requests": len(done),
                 "prefill_flops": sum(flops.prefill_flops(cell.conf, len(p))
                                      for p, _, _, _, _ in done)},
        window=win, release=release,
        check=lambda: gaps(cell.conf, params, rows),
        control=lambda: gaps(cell.conf, params, rows, control=True))
