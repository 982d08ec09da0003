"""How uneven the routing is: the busiest expert's rows of an MoE layer
over the mean expert's, averaged over the timed window's layer-steps, from
the program's model block (``moe_rows_max`` over ``moe_layers``, against
``moe_routed_rows`` over ``moe_expert_slots``). 1 is an even load; the
exchange's padding and the largest expert's products grow with it. Layer:
model step."""


def read(v):
    model = v.facts.counters.get("model") or {}
    if not model.get("moe_layers") or not model.get("moe_routed_rows"):
        return None
    mean = model["moe_routed_rows"] / model["moe_expert_slots"]
    return model["moe_rows_max"] / model["moe_layers"] / mean
