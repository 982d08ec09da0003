"""Time ``DDPTrainer.step`` spent blocked in its buckets' ``Wait`` per step,
from the program's training counters (``wait_ns`` over ``steps``, summed
over the rank threads), across the window, in milliseconds. Layer:
trainer."""


def read(v):
    train = v.facts.counters.get("train") or {}
    if not train.get("steps"):
        return None
    return train["wait_ns"] / train["steps"] / 1e6
