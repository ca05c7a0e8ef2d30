"""Gradient sanitization: zero out non-finite gradient entries (counterpart
of ``geosplatting_tpu/train/grad_utils.py``). The ``nonfinite_grads`` metric
must stay 0 in healthy runs."""
from __future__ import annotations

from typing import Iterable

import torch


@torch.no_grad()
def sanitize(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Zero every non-finite entry of ``grads`` in place; returns the count
    of entries zeroed (a 0-d tensor)."""
    count = None
    for g in grads:
        bad = ~torch.isfinite(g)
        n = bad.sum()
        count = n if count is None else count + n
        g.masked_fill_(bad, 0.0)
    return count if count is not None else torch.zeros((), dtype=torch.long)
