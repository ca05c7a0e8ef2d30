"""Stage 2: ``GeoSplatterMC`` trained by ``GeoSplatMCTrainer.train_step``.

The start state is a stage-1 ``GeoSplatter`` made in memory from the seed
(random field weights, the SDF sphere init), exported and loaded as the
stage-2 task loads a stage-1 run."""
from __future__ import annotations

import torch

from .common import draws_of, stage1_sphere


def shapes(pkg, cfg: dict, traffic: dict) -> dict:
    """Sizes of a step's random inputs: the face jitter (one point a face of
    the field's static budget) and the draws of 6 Gaussians a face."""
    grid = pkg.make_grid(cfg["grid"], scale=cfg["scene_scale"])
    faces = min(cfg["max_render_faces"], 4 * grid.max_surf_edges)
    return {"jitter": (faces, 3), "shade_points": 6 * faces,
            "num_samples_x": cfg["num_samples_x"]}


def build(pkg, cfg: dict, gen: torch.Generator, device):
    """The trainer, its model made from ``gen``."""
    stage1 = stage1_sphere(pkg, cfg, gen, device)
    export = pkg.export_stage1(stage1)
    planes = export["ks_enc"]["planes"].shape
    model = pkg.GeoSplatterMC(
        resolution=cfg["grid"], scale=cfg["scene_scale"], pairs_budget=cfg["pairs_budget"],
        max_render_faces=cfg["max_render_faces"], num_samples_x=cfg["num_samples_x"],
        shadow_steps=cfg["shadow_steps"], denoise=cfg["denoise"],
        triplane_resolution=planes[1], triplane_components=planes[-1], generator=gen,
        device=device)
    model.init_from_stage1(export)
    del stage1, export
    return pkg.GeoSplatMCTrainer(pkg.GeoSplatMCTrainerConfig(batch_size=cfg["batch_size"]),
                                 model)


def train_step(pkg, trainer, cams, gt, step: int, inputs: dict) -> dict:
    return trainer.train_step(cams, gt, float(step), background=inputs["background"],
                              jitter_noise=inputs["jitter"],
                              draws=[draws_of(pkg, d) for d in inputs["draws"]])


def fills(metrics: dict) -> dict:
    """The step's budget fills (> 1 means silent truncation)."""
    return {"pair_fill": float(metrics["pair_fill"]), "face_fill": float(metrics["face_fill"])}


def shaded_points(metrics: dict, cfg: dict, traffic: dict) -> float:
    """Points the step shades per view: its valid Gaussians."""
    return float(metrics["num_gaussians"])


def work(trainer, metrics: dict, cfg: dict, traffic: dict) -> dict:
    """A view's work for ``opcount.view_ops``: the field evaluated on each
    valid face (the trunk at the face, again detached for the z head and at
    the jittered point; the kd, ks, z and occ heads and the jittered kd and
    ks), the shading on each valid Gaussian."""
    from ..opcount import field_ops

    comps = trainer.model.field.trunk.planes.shape[-1]
    return {"samples": cfg["num_samples_x"] ** 2, "shadow_steps": cfg["shadow_steps"],
            "field_points": float(metrics["num_gaussians"]) / 6,
            "field_ops_per_point": field_ops(comps, cfg["field_hidden"], (3, 2, 1, 6, 3, 2), 3)}
