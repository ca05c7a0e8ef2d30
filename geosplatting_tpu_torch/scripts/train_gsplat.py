"""Vanilla 3DGS / 2DGS training CLI with the JAX package's presets
(counterpart of ``scripts/train_gsplat.py``).

    python -m geosplatting_tpu_torch.scripts.train_gsplat blender --dataset_path <scene>
    python -m geosplatting_tpu_torch.scripts.train_gsplat blender-2dgs --dataset_path <scene>
    python -m geosplatting_tpu_torch.scripts.train_gsplat quick --dataset_path <scene> \\
        --device cpu --num_steps 4 --num_init_gaussians 2000 --scale_factor 0.1
    python -m geosplatting_tpu_torch.scripts.train_gsplat resume --dir <run dir>

Every preset is a subcommand with ``--dotted.flag`` overrides.
``blender-2dgs`` trains 2D Gaussian splats (``ops/rasterize_2dgs.py``) with
the normal and distortion regularisers, at budgets that hold its random
start (``PAIRS_PER_GAUSSIAN_2DGS``, ``TILE_CAPACITY_2DGS``).
"""
import dataclasses

from geosplatting_tpu_torch.engine.train_task import (
    PAIRS_PER_GAUSSIAN_2DGS, TILE_CAPACITY_2DGS, GSplatTrainTask, ResumeTask,
)
from geosplatting_tpu_torch.utils.config import run_task_group


def preset(name: str, **kw) -> GSplatTrainTask:
    return dataclasses.replace(GSplatTrainTask(experiment_name=name), **kw)


TASKS = {
    "blender": preset("gsplat-blender", num_steps=7000, batch_size=1),
    "blender-antialiased": preset("gsplat-blender-aa", rasterize_mode="antialiased",
                                  num_steps=7000),
    "blender-2dgs": preset("gsplat-blender-2dgs", rasterize_mode="2dgs", num_steps=7000,
                           pairs_per_gaussian=PAIRS_PER_GAUSSIAN_2DGS,
                           tile_capacity=TILE_CAPACITY_2DGS),
    "quick": preset("gsplat-quick", num_steps=1000, num_init_gaussians=16384),
    "custom": GSplatTrainTask(),
    "resume": ResumeTask(),
}

if __name__ == "__main__":
    run_task_group(TASKS)
