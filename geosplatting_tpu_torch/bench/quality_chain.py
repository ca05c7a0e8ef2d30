"""The three-stage chain trained on the synthetic PBR scene and scored.

Counterpart of ``geosplatting_tpu/bench/quality_chain.py``: the quality
counterpart of the speed runs, with NVS / relight / albedo PSNR and the
roughness MSE of the two-sphere scene (``bench/quality.py``), no dataset
needed. ``geosplatting_tpu_torch/scripts/quality_bench.py`` runs it at a
chosen shape on the card; ``tests/test_torch_quality.py`` holds its tiny
shape to the JAX package's floors on the CPU.

It drives the trainers directly, as the JAX function does: stage 1
(``GeoSplatter`` from the SDF of a sphere of radius 0.45), its export,
stage 2 (``GeoSplatterMC.init_from_stage1``), the compacted stage-2 export,
stage 3 (``GeoSplatterDefer.init_from_stage2``, the geometry frozen), each
camera through the rasterizer's kernels (K1-K3 on the card). The device is
synchronised after every step; a stage's seconds a step are taken after its
step 0.

Deviations from the JAX function, each deliberate:
- no ``tile_capacity`` or ``tile_chunk``: the port has one rasterizer
  backend, the pairs path, whose budget is ``pairs_budget`` (default:
  pairs_per_gaussian x N);
- ``triplane_resolution`` (port-only, the JAX model's 512 by default) sizes
  the material field's triplane, which stages 2 and 3 inherit. The CPU test
  passes 32, so its floors hold at a reduced triplane: at 512 a stage-1
  step takes ~2.7 s on one CPU thread, most of it the Adam update of the
  triplane's 25M texels; ``chip_smoke.py`` holds the JAX shape (512) to
  the same floors on the card;
- stage 3 is built as ``GeoSplatDeferTrainTask`` builds it (mesh tile
  capacity ``MESH_TILE_CAPACITY``, which the model raises to the frozen
  mesh's face count, so its raster keeps every triangle where the JAX model
  keeps 256 a tile and drops the rest without a word);
- ``roughness_mse`` reads the rendered roughness (channel 1 of the ``ks``
  attribute map), as ``RelightEvaler`` does in both packages. The JAX
  function reads channel 0, which is the constant 0 of that map, so its
  number is the masked mean of the ground truth's squared roughness whatever
  the model learnt; the port reports that readout as
  ``roughness_mse_channel0`` beside it, comparable with the JAX package's;
- on the card every stage's peak device memory (``s<k>_peak_mem_gib``), the
  largest of each budget fill over its steps (``s<k>_<fill>``), its
  non-finite gradients summed (``s<k>_nonfinite_grads``) and its last loss
  (``s<k>_loss``) are returned beside the JAX keys, and ``on_stage`` is
  called with each stage's numbers as the stage ends.

Randomness comes from ``torch.Generator``s seeded as the JAX function seeds
its keys (the ground truth from 7, 8 and 9, the models from 1, 2, the step
draws from ``seed``, the evaluation renders from 20 + i and 40 + i) and the
batches from ``np.random.default_rng(seed)``, the JAX function's own
sampler; the two packages' random streams differ all the same.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from .. import _kernels
from ..engine.eval_tasks import estimate_albedo_scaling, image_metrics
from ..graphics import images as gimages
from . import quality as q

FILLS = ("pair_fill", "face_fill", "mesh_tile_fill", "mesh_pair_fill")


def _composite(rgba: torch.Tensor, bg: float = 1.0) -> np.ndarray:
    return torch.clamp(rgba[..., :3] + (1.0 - rgba[..., 3:]) * bg, 0.0, 1.0).cpu().numpy()


def _srgb_rgba(rgba: torch.Tensor) -> torch.Tensor:
    """Linear rgba -> premultiplied sRGB rgba."""
    rgb = gimages.rgb2srgb(torch.clamp(rgba[..., :3], 0, 1)) * rgba[..., 3:]
    return torch.cat((rgb, rgba[..., 3:]), -1)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class _Stage:
    """One stage's loop bookkeeping: the step clock, the fills, the
    non-finite gradients and the peak memory."""

    def __init__(self, name: str, num_steps: int, device, log, every: int):
        self.name, self.num_steps, self.device = name, num_steps, device
        self.log, self.every = log, every
        self.fills: dict[str, float] = {}
        self.nonfinite = 0
        self.metrics: dict = {}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.t0 = self.t1 = time.time()

    def record(self, step: int, metrics: dict) -> None:
        # a host read every step: the device is synchronised, so the stage
        # times hold the step's queued work
        loss = float(metrics["loss"])
        if step == 0:
            self.t1 = time.time()
        self.metrics = metrics
        self.nonfinite += int(metrics["nonfinite_grads"])
        for k in FILLS:
            if k in metrics:
                self.fills[k] = max(self.fills.get(k, 0.0), float(metrics[k]))
        if step % self.every == 0:
            self.log(f"  {self.name} step {step}: loss={loss:.4f} "
                     f"psnr={float(metrics['splat_psnr']):.2f}")

    def numbers(self) -> dict:
        now = time.time()
        n = self.name
        out = {f"{n}_wall_s": now - self.t0,
               f"{n}_s_per_step": (now - self.t1) / max(self.num_steps - 1, 1),
               f"{n}_loss": float(self.metrics["loss"]),
               f"{n}_nonfinite_grads": self.nonfinite,
               **{f"{n}_{k}": v for k, v in self.fills.items()}}
        if self.device.type == "cuda":
            out[f"{n}_peak_mem_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        self.log(f"  {n} wall {out[f'{n}_wall_s']:.1f}s, steady "
                 f"{out[f'{n}_s_per_step']:.3f} s/step")
        return out


def run_quality_chain(
    *,
    img_res: int = 128,
    grid_res: int = 48,
    n_train: int = 24,
    n_test: int = 4,
    batch: int = 4,
    s1_steps: int = 200,
    s2_steps: int = 100,
    s3_steps: int = 50,
    gt_spp_x: int = 16,
    train_spp_x: int = 4,
    light_resolution: int = 128,
    seed: int = 0,
    env_quality: str = "fast",
    fast_metrics: bool = True,
    pairs_budget: int | None = None,
    max_render_faces: int = 1 << 18,
    log: Callable[[str], None] = lambda msg: None,
    on_stage: Callable[[str, dict], None] = lambda name, numbers: None,
    triplane_resolution: int = 512,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Train the three stages on the two-sphere scene and score stage 3;
    returns the JAX function's keys (and the port's, module docstring).
    Runs on the card unless ``device`` names another device."""
    from ..engine.train_task import MESH_TILE_CAPACITY
    from ..models.geosplat import GeoSplatter
    from ..models.geosplat_defer import GeoSplatterDefer
    from ..models.geosplat_mc import GeoSplatterMC, compact_export, export_stage1
    from ..train.geosplat_defer_trainer import GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig
    from ..train.geosplat_mc_trainer import GeoSplatMCTrainer, GeoSplatMCTrainerConfig
    from ..train.geosplat_trainer import GeoSplatTrainer, GeoSplatTrainerConfig

    device = _kernels.resolve_device(device)
    gen = _generator(device, seed)
    rng = np.random.default_rng(seed)
    results: dict[str, Any] = {}

    train_cams = q.make_cameras("train", n_train, width=img_res, height=img_res, device=device)
    test_cams = q.make_cameras("test", n_test, width=img_res, height=img_res, device=device)
    env_train = q.make_envmap(kind="train", device=device)
    env_relight = q.make_envmap(kind="relight", device=device)

    log("rendering GT views...")
    gt_train = q.render_gt_views(train_cams, env_train, _generator(device, 7), gt_spp_x)
    gt_test = q.render_gt_views(test_cams, env_train, _generator(device, 8), gt_spp_x)
    gt_relit = q.render_gt_views(test_cams, env_relight, _generator(device, 9), gt_spp_x)
    gt_albedo, gt_rough = q.gt_material_maps(test_cams)

    def batches(n_steps):
        for s in range(n_steps):
            idx = rng.choice(n_train, size=batch, replace=False)
            yield s, torch.as_tensor(idx, device=device)

    def finish(stage: _Stage) -> None:
        numbers = stage.numbers()
        results.update(numbers)
        on_stage(stage.name, numbers)

    # ---- stage 1 ----------------------------------------------------------
    log("stage 1...")
    s1 = GeoSplatter(
        resolution=grid_res, light_resolution=light_resolution, scale=1.0,
        env_quality=env_quality, pairs_budget=pairs_budget, max_render_faces=max_render_faces,
        triplane_resolution=triplane_resolution, generator=_generator(device, 1), device=device,
    )
    with torch.no_grad():
        s1.sdf.copy_(torch.linalg.norm(s1.grid.base_vertices(device), dim=-1) - 0.45)
    t1 = GeoSplatTrainer(
        GeoSplatTrainerConfig(num_steps=s1_steps, batch_size=batch,
                              vertex_sample_warmup=min(50, max(s1_steps // 8, 2))),
        s1,
    )
    stage = _Stage("s1", s1_steps, device, log, 50)
    for step, idx in batches(s1_steps):
        m1 = t1.train_step(train_cams[idx], gt_train[idx], float(step),
                           sampling=t1.sampling_at(step), generator=gen)
        stage.record(step, m1)
    results["s1_train_psnr"] = float(m1["splat_psnr"])
    finish(stage)
    export1 = export_stage1(s1)
    del t1, s1

    # ---- stage 2 ----------------------------------------------------------
    log("stage 2...")
    planes = tuple(export1["ks_enc"]["planes"].shape)
    s2 = GeoSplatterMC(
        resolution=grid_res, scale=1.0, num_samples_x=train_spp_x, pairs_budget=pairs_budget,
        max_render_faces=max_render_faces, triplane_resolution=planes[1],
        triplane_components=planes[-1], generator=_generator(device, 2), device=device,
    )
    s2.init_from_stage1(export1)
    del export1
    t2 = GeoSplatMCTrainer(
        GeoSplatMCTrainerConfig(num_steps=s2_steps, batch_size=batch,
                                geometry_warm_up=min(50, max(s2_steps // 4, 2))),
        s2,
    )
    stage = _Stage("s2", s2_steps, device, log, 25)
    for step, idx in batches(s2_steps):
        stage.record(step, t2.train_step(train_cams[idx], gt_train[idx], float(step),
                                         generator=gen))
    finish(stage)
    export2 = compact_export(s2.export_model())
    del t2, s2

    # ---- stage 3 ----------------------------------------------------------
    log("stage 3...")
    planes = np.shape(export2["ks_enc"]["planes"])
    s3 = GeoSplatterDefer(
        num_gaussians=np.shape(export2["means"])[0], ks_resolution=planes[1],
        ks_components=planes[-1], resolution=grid_res, scale=1.0, num_samples_x=train_spp_x,
        pairs_budget=pairs_budget, mesh_tile_capacity=MESH_TILE_CAPACITY,
        device=device,
    )
    s3.init_from_stage2(export2)
    t3 = GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(num_steps=s3_steps, batch_size=batch), s3)
    stage = _Stage("s3", s3_steps, device, log, 25)
    for step, idx in batches(s3_steps):
        stage.record(step, t3.train_step(train_cams[idx], gt_train[idx], generator=gen))
    finish(stage)
    del t3

    # ---- evaluation (the metric path of engine/eval_tasks.py) -------------
    eval_spp = max(gt_spp_x // 2, 8)
    with torch.no_grad():
        log("eval: NVS...")
        vals = []
        for i in range(n_test):
            rgba, _, _ = s3.render(test_cams[i:i + 1], num_samples_override=eval_spp,
                                   generator=_generator(device, 20 + i))
            vals.append(image_metrics(_composite(_srgb_rgba(rgba[0])), _composite(gt_test[i]),
                                      fast_metrics))
        results["nvs_psnr"] = float(np.mean([v["psnr"] for v in vals]))

        log("eval: albedo + roughness...")
        scale = estimate_albedo_scaling(s3, test_cams, gt_albedo.cpu().numpy()).to(device)
        results["albedo_scaling"] = scale.cpu().numpy().tolist()
        a_vals, r_vals, r0_vals = [], [], []
        for i in range(n_test):
            cam = test_cams[i:i + 1]
            kd_rgba = s3.render_attribute(cam, "kd", albedo_scaling=scale)[0]
            a_vals.append(image_metrics(_composite(_srgb_rgba(kd_rgba)),
                                        _composite(gt_albedo[i]), fast_metrics))
            ks_rgba = s3.render_attribute(cam, "ks")[0]
            mask = (gt_rough[i][..., 1] > 0.5).float()
            denom = max(float(mask.sum()), 1.0)
            for channel, out in ((1, r_vals), (0, r0_vals)):
                err = (ks_rgba[..., channel] - gt_rough[i][..., 0]) ** 2 * mask
                out.append(float(err.sum()) / denom)
        results["albedo_psnr"] = float(np.mean([v["psnr"] for v in a_vals]))
        results["roughness_mse"] = float(np.mean(r_vals))
        results["roughness_mse_channel0"] = float(np.mean(r0_vals))

        log("eval: relighting...")
        rl_vals = []
        for i in range(n_test):
            rgba, _, _ = s3.render(test_cams[i:i + 1], relight_envmap=env_relight,
                                   albedo_scaling=scale, num_samples_override=eval_spp,
                                   generator=_generator(device, 40 + i))
            rl_vals.append(image_metrics(_composite(_srgb_rgba(rgba[0])),
                                         _composite(gt_relit[i]), fast_metrics))
        results["relight_psnr"] = float(np.mean([v["psnr"] for v in rl_vals]))

    if not fast_metrics:
        results["nvs_ssim"] = float(np.mean([v["ssim"] for v in vals]))
        results["relight_ssim"] = float(np.mean([v["ssim"] for v in rl_vals]))
        results["albedo_ssim"] = float(np.mean([v["ssim"] for v in a_vals]))
    return results
