"""Train step (``train/step.py``, ``train/optim.py``, ``models/model.py:loss``):
the window's model FLOPs (``flops.train_flops_per_token``) over its time and
the bf16 dense peak, in %."""

from portbench import flops


def read(seen):
    r = seen.records
    if r.get("kind") != "train" or not r["steps"]:
        return None
    return r["train_flops"] / seen.window_s / flops.BF16_FLOPS * 100
