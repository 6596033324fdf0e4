"""Token pipeline (``data/pipeline.py``, ``io/prefetch.py``,
``launch/train.py:build_batch``): the harness's clock around ``next(pipe)``
and ``build_batch``, summed over the window, in ms a step."""


def read(seen):
    r = seen.records
    if r.get("kind") != "train" or not r["steps"]:
        return None
    return r["pipeline_wait_s"] / r["steps"] * 1e3
