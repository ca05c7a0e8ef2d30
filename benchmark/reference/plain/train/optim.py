"""Per-group Adam with learning-rate schedules.

Counterpart of ``geosplatting_tpu/train/optim.py`` (``make_schedule``,
``OptimizerSpec``, ``GroupOptimizers`` with ``mutate_params``). Each group
is one ``torch.optim.Adam`` param group whose ``lr`` is set from the
schedule before every update, counted from 0 per update as
``optax.scale_by_schedule`` counts; Adam's update mu_hat / (sqrt(nu_hat) +
eps) is optax's ``scale_by_adam``. ``mutate_params`` is the densification's
state surgery (``mutate_optax_state``). ``ModelTrainerState`` is what a
checkpoint keeps of the stage trainers. Both of the JAX package's
schedules are here: "exp" (the trainers') and "cos" (``lr_decay_mode``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch


def make_schedule(lr: float, *, lr_decay: int | None = None, warm_up: int | None = None,
                  mode: str = "exp") -> Callable[[int], float]:
    """The JAX package's schedules in float32. "exp": a quadratic ramp
    (step / warm_up)^2 up to ``warm_up`` steps, then an exponential
    half-life decay over ``lr_decay`` steps counted from ``warm_up``. "cos":
    a linear ramp step / warm_up, then a cosine decay over ``lr_decay``
    steps from ``warm_up`` down to a floor of 5 %; past ``lr_decay`` steps
    the cosine rises again, as the JAX one does (its progress is not
    clamped). Constant after the ramp without ``lr_decay``."""
    if mode not in ("exp", "cos"):
        raise ValueError(f"schedule mode: {mode!r}")
    f32 = np.float32
    off = f32(0.0 if warm_up is None else warm_up)

    def exp_decay(step: int) -> float:
        s = f32(step)
        if warm_up is not None and s < warm_up:
            return float(f32(lr) * (s / f32(warm_up)) ** 2)
        if lr_decay is None:
            return float(f32(lr))
        lam = f32(math.log(2.0) / lr_decay)
        return float(f32(lr) * np.exp(-lam * np.maximum(s - off, f32(0.0)), dtype=f32))

    def cos_decay(step: int) -> float:
        s = f32(step)
        if warm_up is not None and s < warm_up:
            return float(f32(lr) * (s / f32(warm_up)))
        if lr_decay is None:
            return float(f32(lr))
        progress = np.maximum(s - off, f32(0.0)) / f32(lr_decay)
        alpha = f32(0.05)
        decay = ((np.cos(f32(math.pi) * progress, dtype=f32) + f32(1.0)) * f32(0.5)
                 * (f32(1.0) - alpha) + alpha)
        return float(f32(lr) * decay)

    return exp_decay if mode == "exp" else cos_decay


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    lr: float
    eps: float = 1e-15
    lr_decay: int | None = None
    warm_up: int | None = None
    lr_decay_mode: str = "exp"

    def schedule(self) -> Callable[[int], float]:
        return make_schedule(self.lr, lr_decay=self.lr_decay, warm_up=self.warm_up,
                             mode=self.lr_decay_mode)


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

    def group(self, name: str) -> dict:
        return next(g for g in self.adam.param_groups if g["name"] == name)

    @torch.no_grad()
    def mutate_params(self, name: str, params: Sequence[torch.nn.Parameter] | None = None, *,
                      param_map: torch.Tensor | None = None, clear: bool = False) -> None:
        """Re-index the Adam moments of group ``name`` through ``param_map``
        (new slot -> old index, -1 -> zero), or zero them all with
        ``clear``. ``params`` replace the group's parameters (their first
        dimension is ``param_map``'s length). Each parameter's step count
        stays as it was."""
        group = self.group(name)
        old = group["params"]
        new = old if params is None else list(params)
        for p_old, p_new in zip(old, new):
            state = self.adam.state.pop(p_old, None)
            if state is None:   # no update yet: no moments
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                m = state[key]
                if clear:
                    state[key] = torch.zeros_like(m)
                    continue
                idx = param_map.to(m.device)
                out = m[idx.clamp(min=0)]
                out[idx < 0] = 0.0
                state[key] = out
            self.adam.state[p_new] = state
        group["params"] = new

    def lr(self, name: str) -> float:
        return self.schedules[name](self.count)

    def state_dict(self) -> dict:
        return {"optimizer": self.adam.state_dict(), "optimizer_count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["optimizer"])
        self.count = state["optimizer_count"]

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.lr(group["name"])
        self.adam.step()
        self.count += 1


class ModelTrainerState:
    """A checkpoint's state of a trainer whose parameters are its model's:
    the model's state, the Adam state and the update count."""

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), **self.optimizers.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizers.load_state_dict(state)
