"""Stage-1 training CLI with per-scene presets (counterpart of
``scripts/train_geosplat.py``).

    python -m geosplatting_tpu_torch.scripts.train_geosplat custom \\
        --dataset_path <blender scene> --num_steps 4
    python -m geosplatting_tpu_torch.scripts.train_geosplat resume --dir <run dir>

Every preset is a subcommand with ``--dotted.flag`` overrides; a run writes
``outputs/<experiment_name>/<timestamp>/`` with ``task.py``, ``log.txt``,
``ckpts/``, ``dump/`` and ``export.npz``. The port reads the Blender,
Syn4Relight, TensoIR and Shiny Blender layouts.
"""
import dataclasses

from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask, ResumeTask
from geosplatting_tpu_torch.utils.config import run_task_group


def preset(name: str, **kw) -> GeoSplatTrainTask:
    return dataclasses.replace(GeoSplatTrainTask(experiment_name=name), **kw)


S4R = {
    f"s4r-{scene}": preset(
        f"geosplat-s4r-{scene}", resolution=96, scene_scale=0.8,
        num_steps=500, batch_size=8, pairs_budget=1_600_000,
        max_render_faces=1 << 17,
    )
    for scene in ("hotdog", "chair", "jugs", "air_baloons")
}
# the synthetic S4R-layout scene of scripts/make_synthetic_scene.py spans the
# unit box, so it trains at scene_scale 1.0
S4R["s4r-twosphere"] = preset(
    "geosplat-s4r-twosphere", resolution=96, scene_scale=1.0,
    num_steps=500, batch_size=8, pairs_budget=1_600_000,
    max_render_faces=1 << 17,
)
TENSOIR = {
    f"tsir-{scene}": preset(
        f"geosplat-tsir-{scene}", resolution=96, scene_scale=0.9,
        num_steps=500, batch_size=8, pairs_budget=1_600_000,
        max_render_faces=1 << 17,
    )
    for scene in ("lego", "armadillo", "ficus", "hotdog")
}
SHINY = {
    f"sb-{scene}": preset(
        f"geosplat-sb-{scene}", resolution=128, scene_scale=1.05,
        num_steps=500, batch_size=8, initial_guess="specular",
        pairs_budget=2_400_000,
    )
    for scene in ("ball", "car", "coffee", "helmet", "teapot", "toaster")
}
SHINY["sb-lego_highres"] = preset(
    "geosplat-sb-lego_highres", resolution=128, scene_scale=1.05,
    num_steps=1500, batch_size=8,
)

TASKS = {
    **S4R, **TENSOIR, **SHINY,
    "custom": GeoSplatTrainTask(),
    "resume": ResumeTask(),
}

if __name__ == "__main__":
    run_task_group(TASKS)
