"""Model (``models/mla.py``, the absorbed path): host ms a decode step
spends in ``model.attention`` spans with ``path="absorb"``, summed within
each ``serve.decode_step`` span (the same thread, contained in its time)
and averaged over the steps.  None where the program records no such span."""


def read(seen):
    steps = [e for e in seen.spans if e["name"] == "serve.decode_step"]
    absorbed = [e for e in seen.spans if e["name"] == "model.attention"
                and e.get("args", {}).get("path") == "absorb"]
    if not steps or not absorbed:
        return None
    total = 0.0
    for s in steps:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        total += sum(e["dur"] for e in absorbed
                     if e["tid"] == s["tid"] and lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    return total / len(steps) / 1e3
