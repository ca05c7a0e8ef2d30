"""Stage 1: ``GeoSplatter`` trained by ``GeoSplatTrainer.train_step`` at the
recipe's batch of 8 cameras a step, face sampling throughout.

The start state is the SDF sphere init (radius ``sdf_radius``) with random
field weights from the seed; the field, FlexiCubes and the environment's
prefilter run once a step for all of its cameras."""
from __future__ import annotations

import importlib

import torch


def shapes(pkg, cfg: dict, traffic: dict) -> dict:
    """Sizes of a step's random inputs: the face jitter (one point a face of
    the field's static budget); the Monte-Carlo draws, which stage 1 does
    not take, sized to nothing."""
    grid = pkg.make_grid(cfg["grid"], scale=cfg["scene_scale"])
    faces = min(cfg["max_render_faces"], 4 * grid.max_surf_edges)
    return {"jitter": (faces, 3), "shade_points": 0, "num_samples_x": 1}


def build(pkg, cfg: dict, gen: torch.Generator, device):
    """The trainer, its model made from ``gen`` with the SDF sphere init."""
    trainer = importlib.import_module(f"{pkg.root}.train.geosplat_trainer")
    model = pkg.GeoSplatter(
        resolution=cfg["grid"], light_resolution=cfg["light_resolution"],
        scale=cfg["scene_scale"], initial_guess=cfg["initial_guess"],
        max_render_faces=cfg["max_render_faces"], pairs_budget=cfg["pairs_budget"],
        tile_shape=cfg["tile_shape"], env_quality=cfg["env_quality"],
        batched_binning=cfg["batched_binning"],
        triplane_resolution=cfg["triplane_resolution"],
        triplane_components=cfg["triplane_components"], field_hidden=cfg["field_hidden"],
        generator=gen, device=device)
    with torch.no_grad():
        model.sdf.copy_(torch.linalg.norm(model.grid.base_vertices(device), dim=-1)
                        - cfg["sdf_radius"])
    return trainer.GeoSplatTrainer(
        trainer.GeoSplatTrainerConfig(batch_size=cfg["batch_size"]), model)


def train_step(pkg, trainer, cams, gt, step: int, inputs: dict) -> dict:
    return trainer.train_step(cams, gt, float(step), sampling="face",
                              background=inputs["background"], jitter_noise=inputs["jitter"])


def fills(metrics: dict) -> dict:
    """The step's budget fills (> 1 means silent truncation)."""
    return {"pair_fill": float(metrics["pair_fill"]), "face_fill": float(metrics["face_fill"])}


def shaded_points(metrics: dict, cfg: dict, traffic: dict) -> float:
    """Points the step shades per view: its valid Gaussians."""
    return float(metrics["num_gaussians"])


def work(trainer, metrics: dict, cfg: dict, traffic: dict) -> dict:
    """A view's work for ``opcount.view_ops``: no Monte-Carlo samples and no
    sphere trace; the field evaluated once a step on each valid face (the
    trunk at the face, again detached for the z head and at the jittered
    point; the kd, ks and z heads and the jittered kd and ks), an eighth of
    it to each of 8 views. The split-sum lighting (prefilter, lookups) is
    not in ``opcount.py``'s terms."""
    from ..opcount import field_ops

    comps = trainer.model.field.trunk.planes.shape[-1]
    return {"samples": 0, "shadow_steps": 0,
            "field_points": float(metrics["num_gaussians"]) / 6 / traffic["batch"],
            "field_ops_per_point": field_ops(comps, cfg["field_hidden"], (3, 2, 1, 3, 2), 3)}
