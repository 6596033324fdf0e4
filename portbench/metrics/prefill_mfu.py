"""Model (``models/model.py:prefill`` and its layers): the forward FLOPs of
the real prompt tokens (``flops.prefill_flops``) over all ``serve.prefill``
span time and the bf16 dense peak, in %."""

from portbench import flops


def read(seen):
    r = seen.records
    span_s = sum(e["dur"] for e in seen.spans if e["name"] == "serve.prefill") / 1e6
    if r.get("kind") != "serve" or not span_s:
        return None
    return r["prefill_flops"] / span_s / flops.BF16_FLOPS * 100
