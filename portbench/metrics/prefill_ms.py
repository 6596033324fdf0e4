"""Serve engine (``serve/engine.py:_admit``): the ``serve.prefill`` spans'
time over their number, in ms (each span ends once the logits are on the
host)."""


def read(seen):
    durs = [e["dur"] for e in seen.spans if e["name"] == "serve.prefill"]
    return sum(durs) / len(durs) / 1e3 if durs else None
