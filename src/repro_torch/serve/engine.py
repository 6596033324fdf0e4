"""Slot-based batched serving engine.

The port of ``repro/serve/engine.py``: a fixed pool of B cache slots,
prefill and decode steps of one model, finished slots refilled from the
queue (continuous batching).  Decode state is one group-stacked cache tree
(a KV cache for attention layers, the recurrent state for RWKV and Mamba
ones) so one ``decode_step`` serves all slots; a prefill's rows are copied
into the slots it fills, cast to the engine cache's types (Mamba's conv
tail comes out of the prefill in the compute type and is kept in
float32), and each decode step writes its keys and values into the KV
cache in place and returns new recurrent states.  Prompts
admitted together are left-padded with token 0 to one length and
prefilled as they are: the pad is attended to, or runs through the
recurrence, as in the reference.

The engine runs where the parameters live.  Greedy decoding is exact;
temperature sampling draws from an explicit ``torch.Generator`` seeded
with ``seed``, whose stream is not ``jax.random``'s.  The ``serve.prefill``
and ``serve.decode_step`` spans end once the step's result is on the host,
so on the card they time the device's work too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs

__all__ = ["ServeEngine", "sample_logits"]


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """Greedy (t=0) or temperature sampling.  logits: (B, V) float32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _write_rows(full: dict, new: dict, rows: torch.Tensor) -> None:
    """full[:, rows] = new[:, rows] for every leaf of a cache tree, cast
    to full's type."""
    for k, v in full.items():
        if isinstance(v, dict):
            _write_rows(v, new[k], rows)
        else:
            v[:, rows] = new[k][:, rows].to(v.dtype)


@dataclasses.dataclass
class _Slot:
    req_id: int = -1
    pos: int = 0
    out: list = dataclasses.field(default_factory=list)
    max_new: int = 0
    active: bool = False


class ServeEngine:
    """Continuous-batching engine over one model's prefill/decode steps.

    All slots share one prompt length per prefill call (bucketed); decode
    is one token across every active slot per step.
    """

    def __init__(self, model, params, *, batch_slots: int, max_len: int,
                 eos_id: int = 1, temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.cache = model.init_cache(batch_slots, max_len, device=self.device)
        self._queue: list = []
        self._done: dict = {}
        self._next_id = 0

    # -- public API ------------------------------------------------------

    def submit(self, tokens: np.ndarray, max_new: int = 32) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(tokens, np.int32), max_new))
        obs.counter("serve.requests").inc()
        return rid

    @torch.no_grad()
    def run(self) -> dict:
        """Drain the queue; returns {req_id: np.ndarray(generated tokens)}."""
        while self._queue or any(s.active for s in self.slots):
            self._admit()
            self._decode_round()
        out, self._done = self._done, {}
        return out

    # -- internals -------------------------------------------------------

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if not s.active]

    def _admit(self):
        free = self._free_slots()
        if not free or not self._queue:
            return
        take = self._queue[: len(free)]
        del self._queue[: len(take)]
        # bucket to one prompt length: pad left with 0s and prefill at it
        plen = max(len(t) for _, t, _ in take)
        toks = np.zeros((self.B, plen), np.int32)
        for slot_i, (rid, t, max_new) in zip(free, take):
            toks[slot_i, plen - len(t):] = t
        with obs.trace.span("serve.prefill", cat="serve", slots=len(take),
                            plen=plen), \
                obs.profile.mem_phase("serve.prefill"):
            logits, cache = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
                max_len=self.max_len)
            logits_np = logits.float().cpu().numpy()
        # write the prefilled rows into the engine cache
        rows = torch.tensor(free[: len(take)], device=self.device)
        _write_rows(self.cache, cache, rows)
        for slot_i, (rid, t, max_new) in zip(free, take):
            s = self.slots[slot_i]
            s.req_id, s.pos, s.out, s.max_new, s.active = rid, plen, [], max_new, True
            s.out.append(int(np.argmax(logits_np[slot_i])))

    def _decode_round(self, rounds: int = 8):
        for _ in range(rounds):
            active = [i for i, s in enumerate(self.slots) if s.active]
            if not active:
                return
            pos = max(self.slots[i].pos for i in active)
            if pos >= self.max_len - 1:
                for i in active:
                    self._finish(i)
                return
            last = np.zeros((self.B, 1), np.int32)
            for i in active:
                last[i, 0] = self.slots[i].out[-1]
            with obs.trace.span("serve.decode_step", cat="serve",
                                slots=len(active)), \
                    obs.profile.mem_phase("serve.decode_step"):
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache,
                    torch.from_numpy(last).to(self.device), pos)
                nxt = sample_logits(logits, self.generator,
                                    self.temperature).cpu().numpy()
            obs.counter("serve.tokens").inc(len(active))
            for i in active:
                s = self.slots[i]
                tok = int(nxt[i])
                s.out.append(tok)
                s.pos = pos + 1
                if tok == self.eos_id or len(s.out) >= s.max_new:
                    self._finish(i)

    def _finish(self, slot_i: int):
        s = self.slots[slot_i]
        self._done[s.req_id] = np.asarray(s.out, np.int32)
        s.active = False
        obs.counter("serve.completed").inc()
        obs.histogram("serve.gen_tokens").observe(len(s.out))
