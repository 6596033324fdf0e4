"""Serve engine (``serve/engine.py:_decode_round``): the
``serve.decode_step`` spans' time over their number, in ms."""


def read(seen):
    durs = [e["dur"] for e in seen.spans if e["name"] == "serve.decode_step"]
    return sum(durs) / len(durs) / 1e3 if durs else None
