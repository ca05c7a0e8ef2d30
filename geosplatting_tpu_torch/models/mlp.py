"""MLP with the reference's semantics (counterpart of
``geosplatting_tpu/models/mlp.py``'s ``MLPConfig``): ReLU hidden layers, an
output activation ("none", "relu", "sigmoid", "tanh", "softplus", "exp"),
optional biases ``b{i}`` (zero at init), skip connections that feed the
input again ahead of the layers they name, a lazy first width (-1, given
by ``input_dim``) and the JAX package's five init schemes. Weights are
[out, in], the JAX package's layout, stored as parameters ``w{i}``.

The defaults are what the field heads build: no bias and Kaiming-uniform
init (the JAX ``MLPConfig`` defaults to biases and torch's ``nn.Linear``
init, "default"). ``convert.mlp_from_numpy`` / ``mlp_to_numpy`` carry the
weights and biases of a JAX ``MLPConfig`` tree.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": nn.functional.softplus,
    "exp": torch.exp,
}
INITIALIZATIONS = ("default", "kaiming-uniform", "kaiming-normal", "normal", "xavier-uniform")


def _init_weight(w: torch.Tensor, scheme: str, generator: torch.Generator | None) -> None:
    dout, din = w.shape
    if scheme == "kaiming-uniform":      # gain sqrt(2) for relu: sqrt(6 / din)
        bound = math.sqrt(6.0 / din)
        w.uniform_(-bound, bound, generator=generator)
    elif scheme == "kaiming-normal":
        w.normal_(0.0, math.sqrt(2.0 / din), generator=generator)
    elif scheme == "normal":
        w.normal_(0.0, 0.02, generator=generator)
    elif scheme == "xavier-uniform":
        bound = math.sqrt(6.0 / (din + dout))
        w.uniform_(-bound, bound, generator=generator)
    else:                                # torch nn.Linear's: U(-1/sqrt(din), 1/sqrt(din))
        bound = 1.0 / math.sqrt(din)
        w.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    def __init__(
        self,
        layers: tuple[int, ...],
        *,
        activation: str = "none",
        bias: bool = False,
        skip_connections: tuple[int, ...] = (),
        initialization: str = "kaiming-uniform",
        input_dim: int | None = None,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: one of {sorted(_ACTIVATIONS)}")
        if initialization not in INITIALIZATIONS:
            raise ValueError(f"initialization {initialization!r}: one of {INITIALIZATIONS}")
        dims = list(layers)
        if dims[0] == -1:
            if input_dim is None:
                raise ValueError("layers[0] == -1 takes its width from input_dim")
            dims[0] = input_dim
        self.num_layers = len(dims) - 1
        self.activation = _ACTIVATIONS[activation]
        self.bias = bias
        self.skip_connections = tuple(skip_connections)
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            if i in self.skip_connections:
                din += dims[0]
            w = torch.empty((dout, din), device=device)
            with torch.no_grad():
                _init_weight(w, initialization, generator)
            self.register_parameter(f"w{i}", nn.Parameter(w))
            if bias:
                self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(dout, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(self.num_layers):
            if i in self.skip_connections:
                x = torch.cat((inputs, x), -1)
            x = x @ getattr(self, f"w{i}").T
            if self.bias:
                x = x + getattr(self, f"b{i}")
            x = torch.relu(x) if i < self.num_layers - 1 else self.activation(x)
        return x
