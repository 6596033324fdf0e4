"""Faults planted in the program underneath a run, for the tests and the
calibration that show the check catches them.  Each is a context manager
that patches one function of ``repro_torch`` and restores it on exit.

* ``unchanged``: the train step returns the state it was given;
* ``half_batch``: the train step sees the first half of the batch only
  (its loss the mean over those rows);
* ``token``: the serve engine's sampler hands slot 0 the next token id
  after the one it chose, at every decode step (one request's answer);
* ``tokens``: the same for every slot (the sampler off by one).

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_batch", "token", "tokens")


@contextlib.contextmanager
def planted(name: str):
    import repro_torch.serve.engine as engine
    import repro_torch.train as train
    if name in ("unchanged", "half_batch"):
        owner, attr = train, "make_train_step"
        real = train.make_train_step

        def patched(*a, **k):
            step = real(*a, **k)
            if name == "unchanged":
                return lambda state, batch: (state, step(state, batch)[1])
            return lambda state, batch: step(
                state, {key: v[: v.shape[0] // 2] for key, v in batch.items()})
    elif name in ("token", "tokens"):
        owner, attr = engine, "sample_logits"
        real = engine.sample_logits
        rows = slice(0, 1) if name == "token" else slice(None)

        def patched(logits, generator=None, temperature=0.0):
            tok = real(logits, generator, temperature).clone()
            tok[rows] = (tok[rows] + 1) % logits.shape[-1]
            return tok
    else:
        raise ValueError(f"no fault {name!r}; have {NAMES}")
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, real)
