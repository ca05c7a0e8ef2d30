"""Mesh-prior GeoSplatter training CLI (counterpart of
``scripts/train_geosplat_prior.py``): optimise the vertex offsets and the
materials of a user-supplied initial mesh, OBJ or PLY:

    python -m geosplatting_tpu_torch.scripts.train_geosplat_prior object \\
        --dataset_path <blender scene> --mesh_path <mesh.ply>
    python -m geosplatting_tpu_torch.scripts.train_geosplat_prior resume --dir <run dir>

Every preset is a subcommand with ``--dotted.flag`` overrides (``--device
cpu`` runs on the CPU);
a run writes ``outputs/<experiment_name>/<timestamp>/`` with ``task.py``,
``log.txt``, ``ckpts/``, ``dump/`` and ``export.npz``.
"""
import dataclasses

from geosplatting_tpu_torch.engine.train_task import GeoSplatPriorTrainTask, ResumeTask
from geosplatting_tpu_torch.utils.config import run_task_group


def preset(name: str, **kw) -> GeoSplatPriorTrainTask:
    return dataclasses.replace(GeoSplatPriorTrainTask(experiment_name=name), **kw)


TASKS = {
    "object": preset("geosplat-prior-object", num_steps=500, batch_size=8),
    "unbounded": preset("geosplat-prior-unbounded", num_steps=1000, batch_size=4,
                        scene_scale=2.0),
    "custom": GeoSplatPriorTrainTask(),
    "resume": ResumeTask(),
}

if __name__ == "__main__":
    run_task_group(TASKS)
