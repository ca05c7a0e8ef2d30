"""LPIPS perceptual metric (VGG16 backbone + linear heads), weight-gated.

Counterpart of ``geosplatting_tpu/ops/lpips.py``: the same graph (shift and
scale of the input, the 13 VGG16 3x3 convolutions with ReLU in five slices,
each slice's features normalised over channels with eps 1e-10, a 2x2 max
pool with floor rounding between slices, the per-layer linear weights) and
the same weights file, named by ``GEOSPLAT_LPIPS_WEIGHTS``: an ``.npz`` with
``convX_Y_w`` (HWIO, transposed here to OIHW), ``convX_Y_b`` and ``linN_w``.
Nothing is downloaded: without the file ``lpips`` raises
``FileNotFoundError``, which the evaluation reports as ``lpips: None``.

The convolutions are ``torch.nn.functional.conv2d`` in float32, TF32 off (the
JAX package's are ``lax.conv``, not a Pallas kernel).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

_VGG_SLICES = (
    ("conv1_1", "conv1_2"),
    ("conv2_1", "conv2_2"),
    ("conv3_1", "conv3_2", "conv3_3"),
    ("conv4_1", "conv4_2", "conv4_3"),
    ("conv5_1", "conv5_2", "conv5_3"),
)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def weights_path() -> str:
    """The weights file ``GEOSPLAT_LPIPS_WEIGHTS`` names; raises
    FileNotFoundError where it is unset or names no file."""
    path = os.environ.get("GEOSPLAT_LPIPS_WEIGHTS", "")
    if not path:
        raise FileNotFoundError(
            "LPIPS needs pretrained weights: set GEOSPLAT_LPIPS_WEIGHTS to an .npz with "
            "vgg16 conv kernels (convX_Y_w/b, HWIO) and lpips lin weights (linN_w).")
    if not os.path.exists(path):
        raise FileNotFoundError(f"GEOSPLAT_LPIPS_WEIGHTS names {path}, which does not exist")
    return path


@functools.lru_cache(maxsize=2)
def _load_weights(path: str, mtime: float, device: str) -> dict[str, torch.Tensor]:
    """The weights of ``path`` on ``device`` (kernels OIHW); cached per file
    version and device."""
    out = {}
    with np.load(path) as f:
        for k in f.files:
            w = np.asarray(f[k], np.float32)
            if k.endswith("_w") and w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            out[k] = torch.as_tensor(np.ascontiguousarray(w), device=device)
    return out


def _features(weights: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x [N, 3, H, W] in [0, 1] -> the 5 channel-normalised feature maps."""
    shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    h = (x * 2.0 - 1.0 - shift) / scale
    feats = []
    for i, convs in enumerate(_VGG_SLICES):
        for name in convs:
            h = F.relu(F.conv2d(h, weights[f"{name}_w"], weights[f"{name}_b"], padding=1))
        feats.append(h / torch.sqrt((h * h).sum(1, keepdim=True) + 1e-10))
        if i < 4:
            h = F.max_pool2d(h, 2, 2)   # floor mode, as VALID windows
    return feats


@torch.no_grad()
def lpips(pred: torch.Tensor, target: torch.Tensor) -> float:
    """LPIPS(vgg) between [..., H, W, 3] images in [0, 1]."""
    path = weights_path()
    weights = _load_weights(path, os.path.getmtime(path), str(pred.device))
    p = pred.reshape((-1,) + pred.shape[-3:]).permute(0, 3, 1, 2).float()
    t = target.reshape((-1,) + target.shape[-3:]).permute(0, 3, 1, 2).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        fp, ft = _features(weights, p), _features(weights, t)
    total = 0.0
    for i, (a, b) in enumerate(zip(fp, ft)):
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + ((a - b) ** 2 * lin).sum(1).mean(dim=(1, 2))
    return float(total.mean())
