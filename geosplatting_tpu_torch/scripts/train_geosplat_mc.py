"""Stage-2 (Monte-Carlo shading) training CLI with per-scene presets
(counterpart of ``scripts/train_geosplat_mc.py``). It needs a stage-1 run:

    python -m geosplatting_tpu_torch.scripts.train_geosplat_mc custom \\
        --dataset_path <blender scene> --load <stage-1 run dir> --num_steps 4
    python -m geosplatting_tpu_torch.scripts.train_geosplat_mc resume --dir <run dir>

Every preset is a subcommand with ``--dotted.flag`` overrides; a run writes
``outputs/<experiment_name>/<timestamp>/`` with ``task.py``, ``log.txt``,
``ckpts/``, ``dump/`` and the stage-2 ``export.npz`` that stage 3 loads.
The port reads the Blender, Syn4Relight, TensoIR and Shiny Blender
layouts.
"""
import dataclasses

from geosplatting_tpu_torch.engine.train_task import GeoSplatMCTrainTask, ResumeTask
from geosplatting_tpu_torch.utils.config import run_task_group


def preset(name: str, **kw) -> GeoSplatMCTrainTask:
    return dataclasses.replace(GeoSplatMCTrainTask(experiment_name=name), **kw)


S4R = {
    f"s4r-{scene}": preset(
        f"geosplat-mc-s4r-{scene}", resolution=96, scene_scale=0.8,
        num_steps=500, batch_size=8, pairs_budget=1_600_000,
        max_render_faces=1 << 17,
    )
    for scene in ("hotdog", "chair", "jugs", "air_baloons")
}
# the synthetic S4R-layout scene spans the unit box: scene_scale 1.0
S4R["s4r-twosphere"] = preset(
    "geosplat-mc-s4r-twosphere", resolution=96, scene_scale=1.0,
    num_steps=500, batch_size=8, pairs_budget=1_600_000,
    max_render_faces=1 << 17,
)
TENSOIR = {
    f"tsir-{scene}": preset(
        f"geosplat-mc-tsir-{scene}", resolution=96, scene_scale=0.9,
        num_steps=500, batch_size=8, pairs_budget=1_600_000,
        max_render_faces=1 << 17,
    )
    for scene in ("lego", "armadillo", "ficus", "hotdog")
}
SHINY = {
    f"sb-{scene}": preset(
        f"geosplat-mc-sb-{scene}", resolution=128, scene_scale=1.05,
        num_steps=1000, batch_size=8, initial_guess="specular",
        pairs_budget=2_400_000,
    )
    for scene in ("ball", "car", "coffee", "helmet", "teapot", "toaster")
}

TASKS = {
    **S4R, **TENSOIR, **SHINY,
    "custom": GeoSplatMCTrainTask(),
    "resume": ResumeTask(),
}

if __name__ == "__main__":
    run_task_group(TASKS)
