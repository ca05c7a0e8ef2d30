"""Stage 2 (Monte-Carlo shading) of GeoSplatting: so far only the stage-1
hand-off it reads.

Counterpart of ``geosplatting_tpu/models/geosplat_mc.py``: ``export_stage1``
writes the dictionary that the JAX package's ``GeoSplatterMC
.init_from_stage1`` reads from ``export.npz``. The stage-2 model itself is
not ported yet.
"""
from __future__ import annotations

import torch

from .geosplat import GeoSplatter, export_ks_bundle


def export_stage1(model: GeoSplatter) -> dict:
    """The stage-1 export (keys and layout of the JAX package's
    ``export_stage1``), as detached tensors and Python scalars."""
    with torch.no_grad():
        return {
            "geom_scale": model.scale,
            "resolution": model.resolution,
            "min_roughness": model.min_roughness,
            "max_metallic": model.max_metallic,
            "exposure": model.exposure.detach(),
            "cubemap": model.cubemap.detach(),
            "deform": model.deform.detach(),
            "weights": model.weights.detach(),
            "sdf": model.sdf.detach(),
            "ks_enc": export_ks_bundle(model.field),
            "initial_guess": model.initial_guess_bias.detach(),
        }
