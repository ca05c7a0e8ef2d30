"""The ranks of tests/test_torch_dp.py and their tiny setups.

A rank is a fresh process (``parallel.sharding.spawn_gloo``) that imports
this module and the port, never JAX. Every setup is built from fixed seeds
on the CPU, so a rank and the test process build the same model, cameras
and ground truth. A rank writes what it measured to ``rank<r>.pt`` in the
directory it is given.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

W = H = 32
STEP_SEED = 7


def _cameras(n: int, size: int = W):
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    return Cameras.from_orbit(center=torch.zeros(3), radius=2.0, elevation_degrees=20.0,
                              num_samples=n, width=size, height=size, device="cpu")


def _sphere_views(cams):
    from tests.torch_scenes import sphere_gt

    return sphere_gt(cams)


def _stage1_model():
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter

    gen = torch.Generator().manual_seed(1)
    model = GeoSplatter(resolution=8, light_resolution=16, scale=1.0, max_render_faces=1024,
                        triplane_resolution=16, generator=gen, device="cpu")
    with torch.no_grad():
        model.sdf.copy_(torch.linalg.norm(model.grid.base_vertices("cpu"), dim=-1) - 0.45)
        # off FlexiCubes' symmetric zeros (ROADMAP C: kinks hit by rounding)
        model.deform.copy_(0.05 * torch.randn(model.deform.shape, generator=gen))
        model.weights.add_(0.05 * torch.randn(model.weights.shape, generator=gen))
    return model


def setup_stage1():
    from geosplatting_tpu_torch.train.geosplat_trainer import (
        GeoSplatTrainer, GeoSplatTrainerConfig,
    )

    cams = _cameras(4)
    return GeoSplatTrainer(GeoSplatTrainerConfig(batch_size=4), _stage1_model()), cams, \
        _sphere_views(cams)


def _stage2_model():
    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC, export_stage1

    export = export_stage1(_stage1_model())
    planes = np.shape(export["ks_enc"]["planes"])
    model = GeoSplatterMC(resolution=8, scale=1.0, num_samples_x=2, shadow_steps=4,
                          max_render_faces=1024, triplane_resolution=planes[1],
                          triplane_components=planes[-1],
                          generator=torch.Generator().manual_seed(2), device="cpu")
    model.init_from_stage1(export)
    return model


def setup_stage2():
    from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
        GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
    )

    cams = _cameras(2)
    return GeoSplatMCTrainer(GeoSplatMCTrainerConfig(batch_size=2), _stage2_model()), cams, \
        _sphere_views(cams)


def setup_stage3():
    from geosplatting_tpu_torch.engine.train_task import stage2_export
    from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
        GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
    )

    export = stage2_export(_stage2_model())
    planes = np.shape(export["ks_enc"]["planes"])
    model = GeoSplatterDefer(num_gaussians=np.shape(export["means"])[0],
                             ks_resolution=planes[1], ks_components=planes[-1], resolution=8,
                             scale=1.0, num_samples_x=2, shadow_steps=4,
                             mesh_tile_capacity=1024, device="cpu")
    model.init_from_stage2(export)
    cams = _cameras(2, 24)
    return GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=2), model), cams, \
        _sphere_views(cams)


def setup_gsplat():
    from geosplatting_tpu_torch.graphics.splats import Splats
    from geosplatting_tpu_torch.models.gsplatter import GSplatter
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    cams = _cameras(4)
    trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=4),
                            GSplatter(sh_degree=1, pairs_per_gaussian=32, device="cpu"),
                            dataset_size=4)
    trainer.init_state(Splats.random(256, sh_degree=1, random_scale=0.7,
                                     generator=torch.Generator().manual_seed(3), device="cpu"))
    return trainer, cams, _sphere_views(cams)


SETUPS = {"stage1": setup_stage1, "stage2": setup_stage2, "stage3": setup_stage3,
          "gsplat": setup_gsplat}


def step(name: str, trainer, cams, gt, gen, dp: bool) -> dict:
    """One step of ``name``: the data-parallel step on a rank (``dp``),
    else the single-process step on the whole batch."""
    fn = trainer.train_step_dp if dp else trainer.train_step
    if name == "stage1":
        return fn(cams, gt, 200.0, sampling="face", generator=gen)
    if name == "stage2":
        return fn(cams, gt, 60.0, generator=gen)
    if name == "stage3":
        return fn(cams, gt, generator=gen)
    return fn(cams, gt, max_sh_degree=1, generator=gen)


def named_params(name: str, trainer) -> dict:
    """The trained parameters (3DGS: those with an optimizer group)."""
    if name == "gsplat":
        return {k: trainer.params[k] for k in trainer.specs}
    return dict(trainer.model.named_parameters())


def snapshot(name: str, trainer, metrics: dict) -> dict:
    """The step's gradients (after the reduce and the trainer's own scaling
    and sanitizing, before nothing else touches them), its metrics and, for
    3DGS, the densification statistics."""
    out = {"grads": {k: p.grad.detach().clone() for k, p in named_params(name, trainer).items()},
           "metrics": {k: float(v) for k, v in metrics.items()}}
    if name == "gsplat":
        out["stats"] = {"xys_grad_norm": trainer.xys_grad_norm.clone(),
                        "vis_counts": trainer.vis_counts.clone()}
    return out


def dp_rank(rank: int, world: int, outdir: str, scene: str) -> None:
    """Every setup: one data-parallel step (its snapshot), a second step
    (the parameters after it); then the sharded renders, the indivisible
    batch, and a data-parallel 3DGS task on ``scene`` run from ``outdir``."""
    from geosplatting_tpu_torch.engine.train_task import GSplatTrainTask
    from geosplatting_tpu_torch.parallel.sharding import shard_batch

    torch.set_num_threads(1)
    results = {}
    for name, setup in SETUPS.items():
        trainer, cams, gt = setup()
        gen = torch.Generator().manual_seed(STEP_SEED)
        first = snapshot(name, trainer, step(name, trainer, cams, gt, gen, dp=True))
        step(name, trainer, cams, gt, gen, dp=True)
        results[name] = {**first, "params": {k: p.detach().clone() for k, p in
                                             named_params(name, trainer).items()}}
    results["sharded"] = sharded_renders(rank, world)
    try:
        shard_batch(_cameras(3), rank, world)
    except ValueError as e:
        results["indivisible"] = str(e)

    os.chdir(outdir)   # the task writes outputs/ under the working directory
    task = GSplatTrainTask(dataset_path=Path(scene), data_parallel=True, batch_size=2,
                           num_steps=2, num_steps_per_save=1, num_steps_per_val=2,
                           num_val_images=1, num_init_gaussians=200, sh_degree=1,
                           scale_factor=W / 800, device="cpu")
    results["task"] = task.run()
    try:
        GSplatTrainTask(dataset_path=Path(scene), data_parallel=True, batch_size=3,
                        num_steps=1, num_init_gaussians=200, scale_factor=W / 800,
                        device="cpu").run()
    except ValueError as e:
        results["task_indivisible"] = str(e)
    torch.save(results, Path(outdir) / f"rank{rank}.pt")


# --- the sharded renders -------------------------------------------------------
# the images at tests/test_tile_sharding.py's shapes (400 Gaussians, 96 x 80);
# the gradients at tests/test_gs_sharding.py's scene (512 random Gaussians of
# SH degree 1 at 64 x 48), the inputs its gradient bound was set at
SCENES = {"forward": (96, 80), "grads": (64, 48)}
SHARDED_KW = {"tile": {"rasterize_mode": "classic"}, "gs": {"rasterize_mode": "antialiased"}}


def render_inputs(which: str) -> tuple[dict, object, dict]:
    """(Gaussians as numpy arrays, the port's camera, rasterize keywords)."""
    from geosplatting_tpu_torch.graphics import gmath
    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.graphics.splats import Splats

    width, height = SCENES[which]
    rng = np.random.default_rng(0)
    if which == "forward":
        n = 400
        q = rng.normal(size=(n, 4)).astype(np.float32)
        scene = {
            "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
            "scales": np.exp(rng.uniform(-4.5, -2.0, (n, 3))).astype(np.float32),
            "opacities": rng.uniform(0.3, 0.95, n).astype(np.float32),
            "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        }
        cam = Cameras.from_lookat(torch.tensor([2.0, 1.0, 1.5]), torch.zeros(3), width=width,
                                  height=height)
        return scene, cam, {}
    n = 512
    sp = Splats.random(n, sh_degree=1, random_scale=0.7, device="cpu",
                       uniform=torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)),
                       quat_normal=torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)))
    scene = {"means": sp.means, "quats": gmath.safe_normalize(sp.quats),
             "scales": torch.exp(sp.scales), "opacities": torch.sigmoid(sp.opacities[:, 0]),
             "colors": torch.cat((sp.colors[:, None], sp.shs), 1)}
    cam = Cameras.from_orbit(center=torch.zeros(3), radius=2.3, elevation_degrees=20.0,
                             num_samples=2, width=width, height=height, device="cpu")[0]
    return {k: v.numpy() for k, v in scene.items()}, cam, {"sh_degree": 1}


def render_loss(render, alpha):
    return (render ** 2).sum() + alpha.sum()


def sharded_renders(rank: int, world: int) -> dict:
    """Each sharded render's image at the "forward" scene, and at the
    "grads" scene the gradient of ``render_loss`` with respect to the
    Gaussians: the band render's for all of them (they are replicated), the
    Gaussian-sharded render's for this rank's own."""
    from geosplatting_tpu_torch.parallel.gs_sharding import rasterize_gs_sharded
    from geosplatting_tpu_torch.parallel.sharding import shard_batch
    from geosplatting_tpu_torch.parallel.tile_sharding import rasterize_tile_sharded

    out = {}
    for which in SCENES:
        arrays, cam, kw = render_inputs(which)
        for kind, fn in (("tile", rasterize_tile_sharded), ("gs", rasterize_gs_sharded)):
            scene = {k: torch.from_numpy(v) for k, v in arrays.items()}
            if kind == "gs":
                scene = shard_batch(scene, rank, world)
            leaves = {k: v.clone().requires_grad_(which == "grads") for k, v in scene.items()}
            mode = SHARDED_KW[kind] if which == "forward" else {}
            render, alpha = fn(*leaves.values(), cam.view_matrix, cam.intrinsic_matrix,
                               *SCENES[which], **kw, **mode)
            if which == "grads":
                render_loss(render, alpha).backward()
                out[(which, kind)] = {k: v.grad for k, v in leaves.items()}
            else:
                out[(which, kind)] = {"render": render.detach(), "alpha": alpha.detach()}
    return out
