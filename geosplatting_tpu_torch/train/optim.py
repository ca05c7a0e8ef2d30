"""Per-group Adam with learning-rate schedules.

Counterpart of ``geosplatting_tpu/train/optim.py`` (``make_schedule``,
``OptimizerSpec``, ``GroupOptimizers``). Each group is one ``torch.optim.Adam``
param group whose ``lr`` is set from the schedule before every update,
counted from 0 per update as ``optax.scale_by_schedule`` counts; Adam's
update mu_hat / (sqrt(nu_hat) + eps) is optax's ``scale_by_adam``.
Densification state surgery is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch


def make_schedule(lr: float, *, lr_decay: int | None = None) -> Callable[[int], float]:
    """Exponential half-life decay of ``lr`` over ``lr_decay`` steps (constant
    without it), evaluated in float32 like the JAX package's "exp" schedule."""
    f32 = np.float32

    def exp_decay(step: int) -> float:
        if lr_decay is None:
            return float(f32(lr))
        lam = f32(math.log(2.0) / lr_decay)
        return float(f32(lr) * np.exp(-lam * f32(step), dtype=f32))

    return exp_decay


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    lr: float
    eps: float = 1e-15
    lr_decay: int | None = None

    def schedule(self) -> Callable[[int], float]:
        return make_schedule(self.lr, lr_decay=self.lr_decay)


class GroupOptimizers:
    """Named Adam groups over named lists of parameters. ``step`` applies
    each group's gradients (read from ``.grad``) with its scheduled lr."""

    def __init__(self, specs: Mapping[str, OptimizerSpec],
                 params: Mapping[str, Sequence[torch.nn.Parameter]]):
        self.specs = dict(specs)
        self.schedules = {k: s.schedule() for k, s in self.specs.items()}
        groups = [
            {"params": list(params[k]), "lr": s.lr, "eps": s.eps, "name": k}
            for k, s in self.specs.items()
        ]
        self.adam = torch.optim.Adam(groups, foreach=False)
        self.count = 0

    def lr(self, name: str) -> float:
        return self.schedules[name](self.count)

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.lr(group["name"])
        self.adam.step()
        self.count += 1
