"""Carry stage-1 weights between the JAX package's parameter tree and the
port's ``GeoSplatter``.

The JAX tree (``GeoSplatter.init``) is ``{"sdf", "deform", "weights",
"cubemap", "exposure", "field": {"planes", "kd": {"w0", "w1"}, "ks": {...},
"z": {...}}}``, given here as numpy arrays (the caller converts). MLP
weights are [out, in] on both sides and triplane planes [3, R, R, C], so
nothing is transposed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_TOP = ("sdf", "deform", "weights", "cubemap", "exposure")
_HEADS = ("kd", "ks", "z")


def params_from_numpy(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX stage-1 parameter tree (numpy leaves) -> ``GeoSplatter``
    state-dict entries; load them with ``model.load_state_dict(...)``."""
    out = {k: torch.from_numpy(np.array(tree[k], dtype=np.float32)) for k in _TOP}
    field = tree["field"]
    out["field.trunk.planes"] = torch.from_numpy(np.array(field["planes"], dtype=np.float32))
    for head in _HEADS:
        for name, leaf in field[head].items():
            out[f"field.{head}.{name}"] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """``GeoSplatter`` state dict -> the JAX stage-1 parameter tree layout
    with numpy leaves."""
    tree = {k: state[k].detach().cpu().numpy() for k in _TOP}
    field: dict = {"planes": state["field.trunk.planes"].detach().cpu().numpy()}
    for head in _HEADS:
        prefix = f"field.{head}."
        field[head] = {
            k[len(prefix):]: v.detach().cpu().numpy()
            for k, v in state.items() if k.startswith(prefix)
        }
    tree["field"] = field
    return tree
