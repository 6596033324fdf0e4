"""Token pipeline (``data/pipeline.py:TokenPipeline.__next__``): host ms a
step that the trainer waits in the ``pipeline.next`` spans, its own wait
for the prefetch thread's next batch."""


def read(seen):
    r = seen.records
    durs = [e["dur"] for e in seen.spans if e["name"] == "pipeline.next"]
    if r.get("kind") != "train" or not r["steps"] or not durs:
        return None
    return sum(durs) / r["steps"] / 1e3
