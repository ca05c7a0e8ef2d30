"""Carry weights between the JAX package's parameter trees and the port's
``GeoSplatter`` (stage 1), ``GeoSplatterMC`` (stage 2),
``GeoSplatterDefer`` (stage 3) and ``GeoSplatterPrior`` (the mesh prior).

The JAX trees are ``{"sdf", "deform", "weights", "cubemap", "exposure",
"field": {"planes", "kd": {"w0", "w1"}, "ks": {...}, "z": {...}}}`` for
stage 1 (``GeoSplatter.init``) and the same with ``latlng`` in place of
``cubemap`` and an ``occ`` head in ``field`` for stage 2
(``GeoSplatterMC.init_from_stage1``), given here as numpy arrays (the caller
converts). The stage-3 tree (``GeoSplatterDefer.init_from_stage2``) is
flat: the Gaussians' ``means``, ``scales``, ``quats``, ``opacities``,
``normals``, ``kd``, ``occ``, then ``exposure``, ``latlng_hue``,
``latlng_value`` and the nested ``ks_enc`` {``planes``, ``ks`` {``w0``,
``w1``}}. MLP weights are [out, in] on both sides and triplane planes
[3, R, R, C], so nothing is transposed.

The hash-grid field (``GaussianField``) is ``{"kd_enc", "ks_enc", "z_enc"[,
"occ_enc"]}``, each ``{"table": [L * T, F], "mlp": {"w0", ...}}``, and a
stage-3 hash ``ks_enc`` is one such encoder: both map to the state dict
name for name. The prior's tree is ``{"deform", "latlng", "exposure",
"field"}`` and, without the jitter smoothing, ``kdks`` [6F, 5] and ``zs``
[6F, 1]; its base mesh is a buffer, not a parameter.

A standalone JAX ``MLPConfig`` tree, ``{"w0", "b0", "w1", ...}`` ([out, in]
weights, [out] biases), is the state dict of the port's ``MLP`` name for
name (``mlp_from_numpy`` / ``mlp_to_numpy``).

Vanilla 3DGS (``GSplatTrainer.init_state``): the params tree is flat,
``means``, ``scales``, ``quats``, ``colors``, ``opacities`` and ``shs``,
which is also the JAX task's export; each Adam group's state is the
first and second moments ``mu`` and ``nu`` of its one leaf and the
update ``count`` (optax's ``ScaleByAdamState``). The ``2dgs`` mode trains
the same tree (its disks read the first two of the three scales; the third
is kept and takes no gradient), so ``splats_to_numpy`` and
``splats_from_numpy`` carry 2DGS splats as they are.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_TOP = ("sdf", "deform", "weights", "cubemap", "latlng", "exposure", "kdks", "zs")
_HEADS = ("kd", "ks", "z", "occ")
_STAGE3 = ("means", "scales", "quats", "opacities", "normals", "kd", "occ", "exposure",
           "latlng_hue", "latlng_value")


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _flatten(tree: Mapping, prefix: str) -> dict[str, torch.Tensor]:
    """Nested dict -> {"<prefix>.<key>.<key>": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = _f32(v)
    return out


def _unflatten(state: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """The entries of ``state`` under ``prefix`` as a nested dict of numpy."""
    out: dict = {}
    for k, v in state.items():
        if not k.startswith(prefix + "."):
            continue
        *path, leaf = k[len(prefix) + 1:].split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def params_from_numpy(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX stage-1, stage-2 or stage-3 parameter tree (numpy leaves) ->
    state-dict entries of the port's model; load them with
    ``model.load_state_dict``."""
    if "latlng_hue" in tree:
        out = {k: _f32(tree[k]) for k in _STAGE3}
        out.update(_flatten(tree["ks_enc"], "ks_enc"))
        return out
    out = {k: torch.from_numpy(np.array(tree[k], dtype=np.float32)) for k in _TOP if k in tree}
    field = tree["field"]
    if "planes" not in field:   # the hash-grid field
        out.update(_flatten(field, "field"))
        return out
    out["field.trunk.planes"] = torch.from_numpy(np.array(field["planes"], dtype=np.float32))
    for head in _HEADS:
        for name, leaf in field.get(head, {}).items():
            out[f"field.{head}.{name}"] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict of the port's model -> the JAX parameter tree layout with
    numpy leaves."""
    if "latlng_hue" in state:
        tree = {k: state[k].detach().cpu().numpy() for k in _STAGE3}
        tree["ks_enc"] = _unflatten(state, "ks_enc")
        return tree
    tree = {k: state[k].detach().cpu().numpy() for k in _TOP if k in state}
    if "field.trunk.planes" not in state:   # the hash-grid field
        tree["field"] = _unflatten(state, "field")
        return tree
    field: dict = {"planes": state["field.trunk.planes"].detach().cpu().numpy()}
    for head in _HEADS:
        prefix = f"field.{head}."
        leaves = {k[len(prefix):]: v.detach().cpu().numpy()
                  for k, v in state.items() if k.startswith(prefix)}
        if leaves:
            field[head] = leaves
    tree["field"] = field
    return tree


def mlp_from_numpy(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``MLPConfig`` parameters (``w{i}``, ``b{i}``) -> the state dict
    of ``models.mlp.MLP``; load it with ``load_state_dict``."""
    return {k: _f32(v) for k, v in tree.items()}


def mlp_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict of ``models.mlp.MLP`` -> the JAX ``MLPConfig`` tree."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


# --- vanilla 3DGS -------------------------------------------------------------------


def splats_from_numpy(tree: Mapping, device=None):
    """3DGS params tree (numpy leaves) -> the port's ``Splats``."""
    from .graphics.splats import FIELDS, Splats

    return Splats(**{k: _f32(tree[k]).to(device) for k in FIELDS})


def splats_to_numpy(splats) -> dict:
    """``Splats`` -> the JAX package's 3DGS params tree with numpy leaves."""
    from .graphics.splats import FIELDS

    return {k: getattr(splats, k).detach().cpu().numpy() for k in FIELDS}


def adam_to_numpy(optimizers) -> dict:
    """Each group's Adam state of a ``GroupOptimizers`` whose groups hold
    one parameter each -> {group: {"mu", "nu", "count"}} (numpy)."""
    out = {}
    for group in optimizers.adam.param_groups:
        state = optimizers.adam.state.get(group["params"][0])
        if state:
            out[group["name"]] = {"mu": state["exp_avg"].cpu().numpy(),
                                  "nu": state["exp_avg_sq"].cpu().numpy(),
                                  "count": int(state["step"])}
    return out


def adam_from_numpy(optimizers, tree: Mapping) -> None:
    """Set the Adam state of each group named in ``tree`` ({group: {"mu",
    "nu", "count"}}) and the schedule's update count."""
    for name, leaf in tree.items():
        p = optimizers.group(name)["params"][0]
        optimizers.adam.state[p] = {
            "step": torch.tensor(float(leaf["count"])),
            "exp_avg": _f32(leaf["mu"]).to(p.device),
            "exp_avg_sq": _f32(leaf["nu"]).to(p.device),
        }
        optimizers.count = int(leaf["count"])
