"""Stage 3: ``GeoSplatterDefer`` trained by ``GeoSplatDeferTrainer.train_step``,
or rendered for relighting as the relight evaluation renders a chunk.

The start state is a stage-2 export of a ``GeoSplatterMC`` made in memory
from the seed (a stage-1 ``GeoSplatter`` with the SDF sphere init and random
weights, loaded into stage 2), compacted as the stage-2 task exports it."""
from __future__ import annotations

import torch

from .common import draws_of, stage1_sphere


def shapes(pkg, cfg: dict, traffic: dict) -> dict:
    """Sizes of the random inputs: the ks jitter (one row a Gaussian, set
    once the model is built) and the draws of one point a pixel."""
    r = traffic["resolution"]
    return {"jitter": None, "shade_points": r * r, "num_samples_x": cfg["num_samples_x"]}


def build_model(pkg, cfg: dict, gen: torch.Generator, device):
    stage1 = stage1_sphere(pkg, cfg, gen, device)
    export1 = pkg.export_stage1(stage1)
    planes1 = export1["ks_enc"]["planes"].shape
    stage2 = pkg.GeoSplatterMC(resolution=cfg["grid"], scale=cfg["scene_scale"],
                               max_render_faces=cfg["max_render_faces"],
                               triplane_resolution=planes1[1], triplane_components=planes1[-1],
                               generator=gen, device=device)
    stage2.init_from_stage1(export1)
    export = pkg.compact_export(stage2.export_model())
    del stage1, stage2, export1
    planes = export["ks_enc"]["planes"].shape
    model = pkg.GeoSplatterDefer(
        num_gaussians=export["means"].shape[0], ks_resolution=planes[1],
        ks_components=planes[-1], resolution=cfg["grid"], scale=cfg["scene_scale"],
        num_samples_x=cfg["num_samples_x"], shadow_steps=cfg["shadow_steps"],
        pairs_budget=cfg["pairs_budget"], mesh_tile_capacity=cfg["mesh_tile_capacity"],
        device=device)
    model.init_from_stage2(export)
    return model


def build(pkg, cfg: dict, gen: torch.Generator, device):
    """The trainer, its model made from ``gen``."""
    model = build_model(pkg, cfg, gen, device)
    return pkg.GeoSplatDeferTrainer(
        pkg.GeoSplatDeferTrainerConfig(batch_size=cfg["batch_size"]), model)


def jitter_shape(trainer) -> tuple:
    return tuple(trainer.model.means.shape)


def train_step(pkg, trainer, cams, gt, step: int, inputs: dict) -> dict:
    return trainer.train_step(cams, gt, background=inputs["background"],
                              jitter_noise=inputs["jitter"],
                              draws=[draws_of(pkg, d) for d in inputs["draws"]])


def fills(metrics: dict) -> dict:
    return {"pair_fill": float(metrics["pair_fill"]),
            "mesh_tile_fill": float(metrics["mesh_tile_fill"]),
            "mesh_pair_fill": float(metrics["mesh_pair_fill"])}


def shaded_points(metrics: dict, cfg: dict, traffic: dict) -> float:
    """Points shaded per view: every pixel (deferred shading)."""
    return float(traffic["resolution"] ** 2)


@torch.no_grad()
def relight(pkg, model, cams, draws: tuple, scene: dict) -> torch.Tensor:
    """One chunk of the relight evaluation: every camera shares the chunk's
    draws. Returns (sRGB rgb over black [B, H, W, 3], as
    ``RelightEvaler._render_srgb`` makes it, and the render's aux)."""
    d = draws_of(pkg, draws)
    rgba, _, aux = model.render(cams, draws=[d] * len(cams),
                                relight_envmap=scene["envmap"],
                                albedo_scaling=scene["albedo_scaling"])
    rgb = rgba[..., :3].clamp(0, 1)
    rgb = torch.where(rgb <= 0.0031308, 12.92 * rgb,
                      1.055 * torch.pow(torch.clamp(rgb, min=0.0031308), 1.0 / 2.4) - 0.055)
    return (rgb * rgba[..., 3:]).clamp(0, 1), aux


def render_fills(aux: dict) -> dict:
    return {"pair_fill": float(aux["total_pairs"]) / max(aux["max_pairs"], 1),
            "mesh_tile_fill": float(aux["mesh_tile_fill"]),
            "mesh_pair_fill": float(aux["mesh_pair_fill"])}


def _work(model, cfg: dict, heads: tuple, lookups: int) -> dict:
    from ..opcount import field_ops

    return {"samples": cfg["num_samples_x"] ** 2, "shadow_steps": cfg["shadow_steps"],
            "field_points": float(model.num_gaussians),
            "field_ops_per_point": field_ops(model.ks_enc.planes.shape[-1], cfg["field_hidden"],
                                             heads, lookups)}


def work(trainer, metrics: dict, cfg: dict, traffic: dict) -> dict:
    """A training view's work: the roughness field at each Gaussian and at
    its jittered point (the ks regulariser), the shading at every pixel."""
    return _work(trainer.model, cfg, (2, 2), 2)


def render_work(model, cfg: dict, traffic: dict) -> dict:
    """A relight view's work: the roughness field at each Gaussian."""
    return _work(model, cfg, (2,), 1)
