"""The reference of ``Allreduce(SUM)``: the ranks' operands added in rank
order, ``((x0 + x1) + x2) + x3``, in the operands' own type, which MPI's
deterministic reduction and the port promise bit for bit."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def rank_ordered_sum(xs: Sequence[torch.Tensor],
                     compute: Optional[torch.dtype] = None) -> torch.Tensor:
    """The left fold of ``xs``; with ``compute``, each operand and every
    partial sum rounded to that type, the result given back in the operands'
    type (the control: bfloat16 for float32)."""
    want = xs[0].dtype
    acc = xs[0].to(compute or want).clone()
    for x in xs[1:]:
        acc = acc + x.to(compute or want)
    return acc.to(want)
