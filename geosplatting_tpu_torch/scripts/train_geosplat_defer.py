"""Stage-3 (deferred shading) training and evaluation CLI with per-scene
presets (counterpart of ``scripts/train_geosplat_defer.py``). It needs a
stage-2 run:

    python -m geosplatting_tpu_torch.scripts.train_geosplat_defer s4r-hotdog \\
        --dataset_path <s4r scene> --load <stage-2 run dir>
    python -m geosplatting_tpu_torch.scripts.train_geosplat_defer resume --dir <run dir>
    python -m geosplatting_tpu_torch.scripts.train_geosplat_defer reliteval \\
        --dataset_path <s4r scene> --load <stage-3 run dir>

Every preset is a subcommand with ``--dotted.flag`` overrides; a run writes
``outputs/<experiment_name>/<timestamp>/`` with ``task.py``, ``log.txt``,
``ckpts/``, ``dump/`` and the stage-3 ``export.npz`` (parameters and
frozen geometry). ``nvseval`` and ``reliteval`` evaluate a stage-3 run and
write ``eval.json`` into it. The port reads the Blender, Syn4Relight,
TensoIR and Shiny Blender layouts.
"""
import dataclasses

from geosplatting_tpu_torch.engine.train_task import (
    GeoSplatDeferTrainTask, RelightEvalTask, ResumeTask,
)
from geosplatting_tpu_torch.utils.config import run_task_group


def preset(name: str, **kw) -> GeoSplatDeferTrainTask:
    return dataclasses.replace(GeoSplatDeferTrainTask(experiment_name=name), **kw)


S4R = {
    f"s4r-{scene}": preset(
        f"geosplat-defer-s4r-{scene}", resolution=96, scene_scale=0.8,
        num_steps=100, batch_size=8, pairs_budget=1_600_000,
    )
    for scene in ("hotdog", "chair", "jugs", "air_baloons")
}
# the synthetic S4R-layout scene spans the unit box: scene_scale 1.0
S4R["s4r-twosphere"] = preset(
    "geosplat-defer-s4r-twosphere", resolution=96, scene_scale=1.0,
    num_steps=100, batch_size=8, pairs_budget=1_600_000,
)
TENSOIR = {
    f"tsir-{scene}": preset(
        f"geosplat-defer-tsir-{scene}", resolution=96, scene_scale=0.9,
        num_steps=100, batch_size=8, pairs_budget=1_600_000,
    )
    for scene in ("lego", "armadillo", "ficus", "hotdog")
}
SHINY = {
    f"sb-{scene}": preset(
        f"geosplat-defer-sb-{scene}", resolution=128, scene_scale=1.05,
        num_steps=100, batch_size=8, pairs_budget=2_400_000,
    )
    for scene in ("ball", "car", "coffee", "helmet", "teapot", "toaster")
}

TASKS = {
    **S4R, **TENSOIR, **SHINY,
    "custom": GeoSplatDeferTrainTask(),
    "resume": ResumeTask(),
    "nvseval": RelightEvalTask(skip_rlit=True, skip_mat=True),
    "reliteval": RelightEvalTask(),
}

if __name__ == "__main__":
    run_task_group(TASKS)
