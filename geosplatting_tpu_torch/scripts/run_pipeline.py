#!/usr/bin/env python
"""The three-stage pipeline in one process (counterpart of
``scripts/run_pipeline.py``; the reference's ``eval.sh``): stage-1 training,
its export, stage-2 training, its export, stage-3 training, then an
optional ``nvseval`` or ``reliteval``.

    python -m geosplatting_tpu_torch.scripts.run_pipeline --scene hotdog \\
        --dataset_path data/hotdog [--s1-steps 500 --s2-steps 500 --s3-steps 100 \\
        --resolution 96] [--eval reliteval --skip-nvs] [--device cpu]

It builds the models and trainers directly, as the JAX runner does, and
hands each stage to the next in memory (``export_stage1`` ->
``GeoSplatterMC.init_from_stage1``, the compacted stage-2 export ->
``GeoSplatterDefer.init_from_stage2``). One ``torch.Generator`` seeded
``--seed`` builds the models and draws every step's noise, and one batch
iterator runs through the three stages, as the JAX runner's key and
iterator do. It writes ``outputs/pipeline-<scene>/<timestamp>/``:
``log.txt``, ``stage{1,2,3}/export.npz`` (the files the stage tasks write,
so ``--load <run>/stage2`` starts a stage-3 task) and the stage-3 checkpoint
``ckpts/<s3 steps>.pt``.

Flags: the JAX runner's, plus ``--device`` (the card unless "cpu") and the
stage tasks' ``--triplane_resolution``, ``--max_render_faces`` and
``--num_samples_x`` (by default the JAX models': 8 samples a side in stage
2, 4 in stage 3, as the JAX runner builds them). Left out: the JAX
runner's ``--tile_capacity`` (the port's rasterizer is the pairs path,
whose budget is pairs a Gaussian, not a tile's capacity: the stage tasks
have no such option either) and ``--render-rlit`` / ``--render-albedo``
(the JAX runner reads neither).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.bench.quality_chain import StageRecord
from geosplatting_tpu_torch.data.dataset import Dataset
from geosplatting_tpu_torch.engine.experiment import Experiment
from geosplatting_tpu_torch.engine.stage_io import save_export
from geosplatting_tpu_torch.engine.train_task import (
    MESH_TILE_CAPACITY, save_checkpoint, stage2_export, stage3_export,
)
from geosplatting_tpu_torch.models.geosplat import GeoSplatter
from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC, export_stage1
from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
    GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
)
from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
    GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
)
from geosplatting_tpu_torch.train.geosplat_trainer import GeoSplatTrainer, GeoSplatTrainerConfig
from geosplatting_tpu_torch.ui import console


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True)
    ap.add_argument("--dataset_path", type=Path, required=True)
    ap.add_argument("--resolution", type=int, default=96)
    ap.add_argument("--scene_scale", type=float, default=0.8)
    ap.add_argument("--light_resolution", type=int, default=512)
    ap.add_argument("--s1-steps", type=int, default=500)
    ap.add_argument("--s2-steps", type=int, default=500)
    ap.add_argument("--s3-steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scale_factor", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval", choices=["none", "nvseval", "reliteval"], default="none")
    ap.add_argument("--skip-nvs", action="store_true")
    ap.add_argument("--triplane_resolution", type=int, default=512)
    ap.add_argument("--max_render_faces", type=int, default=1 << 18)
    ap.add_argument("--num_samples_x", type=int, default=None,
                    help="stages 2 and 3 (default: the models', 8 and 4)")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap.parse_args(argv)


def run_pipeline(args: argparse.Namespace) -> dict:
    """Train the three stages and evaluate; returns each stage's numbers
    (``StageRecord``: last loss, s/step, non-finite gradients, the largest
    of every fill), the run directory and the evaluation's results."""
    device = _kernels.resolve_device(args.device)
    nsx = {} if args.num_samples_x is None else {"num_samples_x": args.num_samples_x}
    dataset = Dataset(args.dataset_path, scale_factor=args.scale_factor, device=device)
    exp = Experiment(f"pipeline-{args.scene}").setup()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    it = dataset.iter_batches("train", args.batch, seed=args.seed)
    out: dict = {"output_dir": str(exp.base_dir)}

    def stage_loop(name, steps, every, step_fn):
        record = StageRecord(name, steps, device, exp.log, every)
        for step in range(steps):
            cams, gt, _ = next(it)
            record.record(step, step_fn(step, cams, gt))
        numbers = record.numbers()
        out.update(numbers)
        console.print(f"[green]{name} done[/green] ({numbers[f'{name}_wall_s']:.0f}s)")

    # ---- stage 1 ------------------------------------------------------------
    s1 = GeoSplatter(resolution=args.resolution, light_resolution=args.light_resolution,
                     scale=args.scene_scale, max_render_faces=args.max_render_faces,
                     triplane_resolution=args.triplane_resolution, generator=gen, device=device)
    t1 = GeoSplatTrainer(GeoSplatTrainerConfig(num_steps=args.s1_steps, batch_size=args.batch),
                         s1)
    stage_loop("s1", args.s1_steps, 50, lambda step, cams, gt: t1.train_step(
        cams, gt, float(step), sampling=t1.sampling_at(step), generator=gen))
    export1 = export_stage1(s1)
    save_export(exp.base_dir / "stage1" / "export.npz", export1)
    del t1, s1

    # ---- stage 2 ------------------------------------------------------------
    planes = np.shape(export1["ks_enc"]["planes"])
    s2 = GeoSplatterMC(resolution=args.resolution, scale=args.scene_scale,
                       max_render_faces=args.max_render_faces, **nsx,
                       triplane_resolution=planes[1], triplane_components=planes[-1],
                       generator=gen, device=device)
    s2.init_from_stage1(export1)
    del export1
    t2 = GeoSplatMCTrainer(GeoSplatMCTrainerConfig(num_steps=args.s2_steps, batch_size=args.batch),
                           s2)
    stage_loop("s2", args.s2_steps, 50, lambda step, cams, gt: t2.train_step(
        cams, gt, float(step), generator=gen))
    export2 = stage2_export(s2)
    save_export(exp.base_dir / "stage2" / "export.npz", export2)
    del t2, s2

    # ---- stage 3 ------------------------------------------------------------
    planes = np.shape(export2["ks_enc"]["planes"])
    s3 = GeoSplatterDefer(num_gaussians=np.shape(export2["means"])[0], ks_resolution=planes[1],
                          ks_components=planes[-1], resolution=args.resolution,
                          scale=args.scene_scale, mesh_tile_capacity=MESH_TILE_CAPACITY,
                          device=device, **nsx)
    s3.init_from_stage2(export2)
    t3 = GeoSplatDeferTrainer(
        GeoSplatDeferTrainerConfig(num_steps=args.s3_steps, batch_size=args.batch), s3)
    stage_loop("s3", args.s3_steps, 20, lambda step, cams, gt: t3.train_step(
        cams, gt, generator=gen))
    save_export(exp.base_dir / "stage3" / "export.npz", stage3_export(s3, export2))
    save_checkpoint(exp.ckpt_dir, args.s3_steps, t3, gen)

    # ---- evaluation -----------------------------------------------------------
    if args.eval != "none":
        from geosplatting_tpu_torch.engine.eval_tasks import RelightEvaler

        ev = RelightEvaler(model=s3, skip_nvs=args.skip_nvs,
                           skip_rlit=args.eval == "nvseval", skip_mat=args.eval == "nvseval")
        with torch.no_grad():
            results = ev.run(dataset)
        for k, v in results.items():
            console.print(f"{k}: {v}")
        exp.log(f"eval: {results}")
        out["eval"] = results
    return out


def main(argv: list[str] | None = None) -> dict:
    t0 = time.time()
    out = run_pipeline(parse_args(argv))
    console.print(f"pipeline done in {time.time() - t0:.0f}s: {out['output_dir']}")
    return out


if __name__ == "__main__":
    main()
