"""MLP with the reference's semantics (counterpart of
``geosplatting_tpu/models/mlp.py``) as the stage-1 field heads use it:
bias-free layers, ReLU hidden layers, an identity or sigmoid output and
Kaiming-uniform init. Weights are [out, in], the JAX package's layout,
stored as parameters ``w{i}``."""
from __future__ import annotations

import math

import torch
from torch import nn

_ACTIVATIONS = {"none": lambda x: x, "sigmoid": torch.sigmoid}


class MLP(nn.Module):
    def __init__(
        self,
        layers: tuple[int, ...],
        *,
        activation: str = "none",
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.num_layers = len(layers) - 1
        self.activation = _ACTIVATIONS[activation]
        for i, (din, dout) in enumerate(zip(layers[:-1], layers[1:])):
            w = torch.empty((dout, din), device=device)
            with torch.no_grad():
                bound = math.sqrt(6.0 / din)
                w.uniform_(-bound, bound, generator=generator)
            self.register_parameter(f"w{i}", nn.Parameter(w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = x @ getattr(self, f"w{i}").T
            x = torch.relu(x) if i < self.num_layers - 1 else self.activation(x)
        return x
