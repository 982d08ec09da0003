"""``DDPTrainer.step``'s own time per step, from the program's training
counters (``perfvars``: ``step_ns`` over ``steps``, both summed over the
rank threads), read as differences across the window, in milliseconds.
Layer: trainer."""


def read(v):
    train = v.facts.counters.get("train") or {}
    if not train.get("steps"):
        return None
    return train["step_ns"] / train["steps"] / 1e6
