"""The comparison that decides ``correct``, and the control's precision.

Training: the program's first ``compare_steps`` steps against the
reference's from the same seed and inputs, by four numbers, the first three
the worst case over the steps or the leaves (parameters):
- ``loss_gap``: |loss - reference loss| / |reference loss|, worst step;
- ``grad_gap``: the first gradient's norm as Adam got it, |norm - reference
  norm| over the larger of the reference's norm of that leaf and of the
  median leaf, worst leaf;
- ``change_gap``: the same of the parameters' change over the compared
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (below that a leaf moves under Adam by the rounding
  of a gradient that is nought, on either side alike);
- ``image_gap``: the mean absolute gap of the first step's rendered rgba
  (its forward, before any update), over every pixel and channel.
Relighting: the rendered sRGB images of a sampled chunk against the
reference's, by ``pixel_mean_gap`` (the mean absolute gap) and
``pixel_p999_gap`` (the 99.9th percentile of the absolute gap).

The control is the reference computed one precision lower than the
configuration states (float32 with TF32 off): TF32 in matrix products and
convolutions.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

MOVED_GRAD_SHARE = 1e-3


def lower_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _worst_leaf(got: dict, want: dict, names) -> tuple[float, str]:
    names = list(names)
    if not names:
        return 0.0, ""
    median = statistics.median(want[k] for k in names)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_leaf = _worst_leaf(prog["grads"], ref["grads"], ref["grads"])
    median_g = statistics.median(ref["grads"].values())
    moved = [k for k, g in ref["grads"].items() if g >= MOVED_GRAD_SHARE * median_g]
    change, change_leaf = _worst_leaf(prog["change"], ref["change"], moved)
    image = float((prog["image"].double() - ref["image"].double()).abs().mean())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "image_gap": image,
            "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf,
            "nonfinite_steps": prog["nonfinite_steps"] + ref["nonfinite_steps"]}


def train_checks(prog: dict, ref: dict, limits: dict) -> dict:
    n = train_numbers(prog, ref)
    out = {k: {"value": n[k], "limit": limits[k], "ok": n[k] <= limits[k]} for k in limits}
    out["nonfinite_steps"] = {"value": n["nonfinite_steps"], "limit": 0,
                              "ok": n["nonfinite_steps"] == 0}
    return out


def image_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    d = (got.double() - want.double()).abs().numpy().reshape(-1)
    return {"pixel_mean_gap": float(d.mean()), "pixel_p999_gap": float(np.quantile(d, 0.999)),
            "pixel_max_gap": float(d.max())}


def relight_checks(gaps: list[dict], limits: dict) -> dict:
    out = {}
    for k, lim in limits.items():
        v = max(g[k] for g in gaps)
        out[k] = {"value": v, "limit": lim, "ok": v <= lim}
    return out
