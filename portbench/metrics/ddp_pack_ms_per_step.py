"""Time ``DDPTrainer.step`` spent packing gradients into its buckets (the
bucketer's copies to float64) per step, from the program's training
counters (``pack_ns`` over ``steps``, summed over the rank threads), across
the timed window, in milliseconds. Layer: trainer."""


def read(v):
    train = v.facts.counters.get("train") or {}
    if not train.get("steps") or "pack_ns" not in train:
        return None
    return train["pack_ns"] / train["steps"] / 1e6
