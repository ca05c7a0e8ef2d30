"""Carry weights between the JAX package's parameter trees and the port's
``GeoSplatter`` (stage 1) and ``GeoSplatterMC`` (stage 2).

The JAX trees are ``{"sdf", "deform", "weights", "cubemap", "exposure",
"field": {"planes", "kd": {"w0", "w1"}, "ks": {...}, "z": {...}}}`` for
stage 1 (``GeoSplatter.init``) and the same with ``latlng`` in place of
``cubemap`` and an ``occ`` head in ``field`` for stage 2
(``GeoSplatterMC.init_from_stage1``), given here as numpy arrays (the caller
converts). MLP weights are [out, in] on both sides and triplane planes
[3, R, R, C], so nothing is transposed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_TOP = ("sdf", "deform", "weights", "cubemap", "latlng", "exposure")
_HEADS = ("kd", "ks", "z", "occ")


def params_from_numpy(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX stage-1 or stage-2 parameter tree (numpy leaves) -> state-dict
    entries of the port's model; load them with ``model.load_state_dict``."""
    out = {k: torch.from_numpy(np.array(tree[k], dtype=np.float32)) for k in _TOP if k in tree}
    field = tree["field"]
    out["field.trunk.planes"] = torch.from_numpy(np.array(field["planes"], dtype=np.float32))
    for head in _HEADS:
        for name, leaf in field.get(head, {}).items():
            out[f"field.{head}.{name}"] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict of the port's model -> the JAX parameter tree layout with
    numpy leaves."""
    tree = {k: state[k].detach().cpu().numpy() for k in _TOP if k in state}
    field: dict = {"planes": state["field.trunk.planes"].detach().cpu().numpy()}
    for head in _HEADS:
        prefix = f"field.{head}."
        leaves = {k[len(prefix):]: v.detach().cpu().numpy()
                  for k, v in state.items() if k.startswith(prefix)}
        if leaves:
            field[head] = leaves
    tree["field"] = field
    return tree
