"""Time ``DDPTrainer.step`` spent in its float64 SGD-momentum fold
(``_fold``) per step, from the program's training counters
(``optimizer_ns`` over ``steps``, summed over the rank threads), across the
timed window, in milliseconds. Layer: trainer."""


def read(v):
    train = v.facts.counters.get("train") or {}
    if not train.get("steps") or "optimizer_ns" not in train:
        return None
    return train["optimizer_ns"] / train["steps"] / 1e6
