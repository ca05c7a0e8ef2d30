"""The stage-1, stage-2, stage-3 and vanilla-3DGS training tasks, the shared
training loop and the relight evaluation of a stage-3 run.

Counterpart of ``geosplatting_tpu/engine/train_task.py`` (``resume``,
``ResumeTask``, ``RelightEvalTask``, ``_TrainTaskBase.run`` with its
``after_update`` hook, ``GeoSplatTrainTask``, ``GeoSplatMCTrainTask``,
``GeoSplatDeferTrainTask``, ``GeoSplatPriorTrainTask`` and
``GSplatTrainTask``): the loop with
validation PSNR and image dumps on the val split, ``log.txt`` lines, the
alarm on every budget fill a trainer reports, checkpoints and the export
that the next stage loads.
Each run writes its config as ``task.py`` into its output directory, so
``resume`` can rebuild it.

Randomness: one ``torch.Generator`` on the task's device, seeded from
``seed``, builds the model and draws every step's noise. A checkpoint
(``ckpts/<step>.pt``, ``torch.save``) holds the trainer's ``state_dict``
(the model's and the optimizers' state; 3DGS: the Gaussians at that step's
count, their Adam state and the densification statistics), the step and
the generator's state, so a resumed run draws what the uninterrupted run would have drawn.

The tooling of the JAX loop: ``dashboard`` (a live ``rich`` dashboard,
``ui/console.py``; an ImportError naming ``rich`` where it is missing),
``turntable`` ('+z' or '+y': a frame of the ``OptimizationVisualizer``
orbit through the task's ``val_render`` into ``dump/vis/<step>.png`` where
its schedule says) and ``vis_export_every`` (every N steps the task's
``vis_splats`` as a standalone HTML viewer in ``vis_html/<step>.html``;
stages 1 and 3 and 3DGS have them, as in the JAX package). Options of the
JAX tasks without a meaning in the port yet are left out: ``backend``,
``tile_capacity`` and ``data_parallel`` (multi-GPU; with it the stage-3
``train_step_dp``); the prior task keeps ``backend`` (the pairs path) and
``tile_capacity`` (unused) so its presets are the JAX ones. Options the
JAX tasks lack: ``GeoSplatTrainTask.sdf_sphere_init`` (default off) and
``triplane_resolution`` (the JAX model's 512, also the prior task's).
A stage-2 or stage-3 task takes the hash field when the export it loads
carries a hash-grid roughness predictor. The stage-3 task builds its
model with a mesh tile capacity of 1024 where the JAX model keeps 256
(``MESH_TILE_CAPACITY``), which the model raises to the frozen mesh's face
count so that no triangle is dropped, and the 3DGS task budgets 48 screen pairs a
Gaussian where the JAX model's default is 8 (``PAIRS_PER_GAUSSIAN``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import _kernels
from ..data.dataset import Dataset
from ..graphics import images as gimages
from ..utils.config import dump_dataclass_as_str, load_dataclass
from .experiment import Experiment
from .stage_io import find_export, load_export, save_export


def save_checkpoint(ckpt_dir: Path, step: int, trainer, generator: torch.Generator) -> Path:
    path = Path(ckpt_dir) / f"{step}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": step, **trainer.state_dict(), "generator": generator.get_state()},
               path)
    return path


def load_checkpoint(ckpt_dir: Path, trainer, generator: torch.Generator,
                    step: int | None = None) -> int:
    """Restore the latest (or the given) checkpoint into ``trainer`` and
    ``generator``; returns its step."""
    steps = sorted(int(p.stem) for p in Path(ckpt_dir).glob("*.pt") if p.stem.isdigit())
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    state = torch.load(Path(ckpt_dir) / f"{step}.pt", map_location="cpu")
    trainer.load_state_dict(state)
    generator.set_state(state["generator"])
    return state["step"]


def resume(output_dir: Path, step: int | None = None) -> dict:
    """Continue a run from its output directory: rebuild the task from the
    dumped ``task.py`` and restore the latest (or given) checkpoint."""
    output_dir = Path(output_dir)
    task = load_dataclass(output_dir / "task.py")
    return task.run(resume_dir=output_dir, resume_step=step)


@dataclasses.dataclass
class ResumeTask:
    """CLI resume: continue a run from its output directory."""

    dir: Path = Path(".")
    step: int | None = None

    def run(self) -> dict:
        return resume(self.dir, self.step)


@dataclasses.dataclass
class RelightEvalTask:
    """The evaluation of a finished stage-3 run: rebuilds the model from the
    run's ``task.py``, loads its export's parameters and geometry, runs the
    NVS / relight / material metrics on the test split of ``dataset_path``
    and writes them to ``<load>/eval.json``."""

    load: Path = Path(".")
    dataset_path: Path = Path(".")
    scale_factor: float | None = None
    skip_nvs: bool = False
    skip_rlit: bool = False
    skip_mat: bool = False
    fast: bool = True
    seed: int = 0
    device: str | None = None       # the card unless "cpu"

    def run(self) -> dict:
        import json

        from ..convert import params_from_numpy
        from .eval_tasks import RelightEvaler

        load = Path(self.load)
        device = _kernels.resolve_device(self.device)
        task3 = load_dataclass(load / "task.py")
        export = load_export(find_export(load))
        model = task3.make_model(export["params"], device)
        model.load_state_dict(params_from_numpy(export["params"]))
        model.set_geometry(export["geometry"])
        ev = RelightEvaler(model=model, skip_nvs=self.skip_nvs, skip_rlit=self.skip_rlit,
                           skip_mat=self.skip_mat, fast=self.fast, seed=self.seed)
        results = ev.run(Dataset(self.dataset_path, scale_factor=self.scale_factor,
                                 device=device))
        (load / "eval.json").write_text(json.dumps(results, indent=2))
        for k, v in results.items():
            print(f"{k}: {v}")
        return results


# every fill a trainer reports: (its budget, what overflow drops, the knob)
FILLS = {
    "pair_fill": ("pair budget", "farthest gaussians", "pairs_budget / pairs_per_gaussian"),
    "face_fill": ("render-face budget", "faces past the budget", "max_render_faces"),
    "mesh_tile_fill": ("mesh tile capacity", "farthest triangles of a tile",
                       "mesh_tile_capacity"),
    "mesh_pair_fill": ("mesh pair budget", "farthest triangles' tiles", "pairs_per_triangle"),
    "tile_fill": ("tile capacity", "farthest gaussians of a tile", "tile_capacity"),
}


def _psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * float(np.log10(max(mse, 1e-12)))


@dataclasses.dataclass
class _TrainTaskBase:
    """The training loop; subclasses build the model and trainer."""

    dataset_path: Path = Path(".")
    experiment_name: str = "task"
    seed: int = 0
    num_steps: int = 500
    batch_size: int = 8
    num_steps_per_save: int = 250
    num_steps_per_val: int = 100
    num_val_images: int = 2
    scale_factor: float | None = None
    device: str | None = None       # the card unless "cpu"
    dashboard: bool = False         # a live rich dashboard (ui/console.py)
    turntable: str = "disable"      # '+z' | '+y': turntable frames in dump/vis/
    vis_export_every: int = 0       # N > 0: an HTML splat viewer every N steps

    # ---- subclass hooks ----------------------------------------------------
    def build(self, dataset: Dataset, generator: torch.Generator):
        """-> (model, trainer) on the dataset's device."""
        raise NotImplementedError

    def step_fn(self, trainer, cams, gt, generator, step: int) -> dict:
        raise NotImplementedError

    def after_update(self, trainer, step: int, last_wh: tuple[int, int],
                     generator: torch.Generator) -> None:
        """Called after every step (3DGS: densify, cull, reset opacities)."""

    def val_render(self, model, cams) -> torch.Tensor:
        """-> [B, H, W, 4] premultiplied-sRGB rgba prediction."""
        raise NotImplementedError

    def export(self, model) -> dict | None:
        return None

    def vis_splats(self, model):
        """-> ``Splats`` (or a dict of means, scales, quats, opacities,
        colors) for the HTML viewer snapshot, or None where the family has
        no cheap splat view."""
        return None

    # ---- the loop ----------------------------------------------------------
    def run(self, resume_dir: Path | None = None, resume_step: int | None = None) -> dict:
        device = _kernels.resolve_device(self.device)
        dataset = Dataset(self.dataset_path, scale_factor=self.scale_factor, device=device)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        model, trainer = self.build(dataset, generator)

        if resume_dir is not None:
            exp = Experiment.attach(Path(resume_dir)).setup()
        else:
            exp = Experiment(self.experiment_name).setup()
        (exp.base_dir / "task.py").write_text(dump_dataclass_as_str(self))

        start_step = 0
        if resume_dir is not None and exp.ckpt_dir.exists():
            start_step = load_checkpoint(exp.ckpt_dir, trainer, generator, resume_step)
            exp.log(f"resumed from step {start_step}")

        vis = None
        if self.turntable != "disable":
            from ..visualization.turntable import OptimizationVisualizer

            val_cams, _, _ = dataset.get_split(self._val_split(dataset))
            vis = OptimizationVisualizer(up=self.turntable,
                                         resolution=(val_cams.width, val_cams.height),
                                         device=str(device))
            vis.setup(self.num_steps)

        it = dataset.iter_batches("train", self.batch_size, seed=self.seed)
        for _ in range(start_step):  # keep the data order deterministic
            next(it)

        metrics: dict = {}
        val_metrics: dict = {}
        with contextlib.ExitStack() as stack:
            dash = None
            if self.dashboard:
                from ..ui.console import console

                dash = stack.enter_context(
                    console.screen(self.experiment_name, num_steps=self.num_steps))
            t_start = time.time()
            for step in range(start_step, self.num_steps):
                cams, gt, _ = next(it)
                metrics = self.step_fn(trainer, cams, gt, generator, step)
                self.after_update(trainer, step, (cams.width, cams.height), generator)
                if dash is not None:
                    dash(step + 1, {**metrics, **val_metrics})
                self._visualize(model, vis, exp, step + 1)
                last = step + 1 == self.num_steps
                if (step + 1) % self.num_steps_per_val == 0 or last:
                    val_metrics = self._validate(model, dataset, exp, step + 1)
                    its = (step + 1 - start_step) / (time.time() - t_start)
                    line = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
                    exp.log(f"step {step + 1}: {line} "
                            + " ".join(f"{k}={v:.4g}" for k, v in val_metrics.items())
                            + f" it/s={its:.2f}")
                    # a fill >= 1 means its budget is dropping work; > 0.95
                    # means its headroom is gone
                    for name, (budget, dropped, knob) in FILLS.items():
                        fill = float(metrics.get(name, 0.0))
                        if fill > 0.95:
                            msg = (f"WARNING step {step + 1}: {name}={fill:.3f}"
                                   + (f" — {budget} EXCEEDED, {dropped} are being dropped"
                                      if fill >= 1.0 else f" — {budget} nearly full")
                                   + f"; raise {knob} (model config)")
                            exp.log(msg)
                            print(msg, flush=True)
                if (step + 1) % self.num_steps_per_save == 0 or last:
                    save_checkpoint(exp.ckpt_dir, step + 1, trainer, generator)

        export = self.export(model)
        if export is not None:
            save_export(exp.base_dir / "export.npz", export)
            exp.log("export written: export.npz")
        out = {k: float(v) for k, v in metrics.items()}
        out.update(val_metrics)
        out["output_dir"] = str(exp.base_dir)
        return out

    @torch.no_grad()
    def _visualize(self, model, vis, exp: Experiment, step: int) -> None:
        """The turntable frame and the HTML snapshot of ``step``, where due."""
        cam = vis.get_camera(step) if vis is not None else None
        if cam is not None:
            frame = self.val_render(model, cam)
            exp.dump_image(f"vis/{step:06d}.png", frame[0].cpu().numpy())
        if self.vis_export_every > 0 and step % self.vis_export_every == 0:
            splats = self.vis_splats(model)
            if splats is not None:
                from ..visualization.viewer_html import vis_3dgs

                out = vis_3dgs(splats, exp.base_dir / "vis_html" / f"{step:06d}.html")
                exp.log(f"vis_html snapshot: {out}")

    # ---- validation: val-split metrics and image dumps ---------------------
    def _val_split(self, dataset: Dataset) -> str:
        for split in ("val", "test"):
            try:
                dataset.get_split(split)
                return split
            except FileNotFoundError:
                continue
        return "train"

    @torch.no_grad()
    def _validate(self, model, dataset: Dataset, exp: Experiment, step: int) -> dict:
        split = self._val_split(dataset)
        cams, images, _ = dataset.get_split(split)
        n = min(self.num_val_images, len(cams))
        if n == 0:
            return {}
        idx = np.linspace(0, len(cams) - 1, n).astype(np.int64)
        pred = self.val_render(model, cams[torch.as_tensor(idx, device=cams.device)])
        pred = pred.cpu().numpy()
        vals = []
        for i in range(n):
            gt = np.asarray(images[idx[i]])
            p = np.clip(pred[i, ..., :3] + (1 - pred[i, ..., 3:]), 0, 1)
            g = np.clip(gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:]), 0, 1)
            vals.append(_psnr(p, g))
            exp.dump_image(f"{split}/{step:06d}-{i}.png", p)
            if step == self.num_steps_per_val:
                exp.dump_image(f"{split}/gt-{i}.png", g)
        return {"val_psnr": float(np.mean(vals))}


# --- stage 1 ---------------------------------------------------------------------


@dataclasses.dataclass
class GeoSplatTrainTask(_TrainTaskBase):
    """Stage-1 training task (GeoSplatter, GeoSplatTrainer)."""

    experiment_name: str = "geosplat"
    resolution: int = 96
    light_resolution: int = 512
    scene_scale: float = 1.05
    initial_guess: str = "hybrid"
    # screen-pair budget: None sizes the buffers to pairs_per_gaussian x N;
    # presets pass a budget for their shape (watch pair_fill: the loop warns
    # above 0.95, and overflow drops the farthest Gaussians' pairs first)
    pairs_budget: int | None = None
    tile_shape: str = "16"
    max_render_faces: int = 1 << 18
    # None: the JAX task's random SDF init; a radius r: the SDF of a centred
    # sphere, |x| - r (the init of bench.py's stage-1 workload), for runs
    # too short to carve a surface out of the random one
    sdf_sphere_init: float | None = None
    # texels of the material field's triplane trunk, which stages 2 and 3
    # inherit through the export (the JAX model's 512)
    triplane_resolution: int = 512

    def build(self, dataset, generator):
        from ..models.geosplat import GeoSplatter
        from ..train.geosplat_trainer import GeoSplatTrainer, GeoSplatTrainerConfig

        model = GeoSplatter(
            resolution=self.resolution, light_resolution=self.light_resolution,
            scale=self.scene_scale, initial_guess=self.initial_guess,
            pairs_budget=self.pairs_budget, tile_shape=self.tile_shape,
            max_render_faces=self.max_render_faces,
            triplane_resolution=self.triplane_resolution, generator=generator,
            device=dataset.device,
        )
        if self.sdf_sphere_init is not None:
            with torch.no_grad():
                radius = torch.linalg.norm(model.grid.base_vertices(model.device), dim=-1)
                model.sdf.copy_(radius - self.sdf_sphere_init)
        trainer = GeoSplatTrainer(
            GeoSplatTrainerConfig(num_steps=self.num_steps, batch_size=self.batch_size), model)
        return model, trainer

    def step_fn(self, trainer, cams, gt, generator, step):
        return trainer.train_step(cams, gt, float(step), sampling=trainer.sampling_at(step),
                                  generator=generator)

    def val_render(self, model, cams):
        # the jitter only feeds the smoothness terms, not the image: none is drawn
        rgba, _, _ = model.render(cams, kd_perturb_std=0.0, ks_perturb_std=0.0,
                                  quality="exact")
        rgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
        return torch.cat((rgb, rgba[..., 3:]), -1)

    @torch.no_grad()
    def vis_splats(self, model):
        # the face sampling's Gaussians without jitter, coloured by |kd|
        from ..models.geosplat import get_gaussians_from_face

        mesh, _, _ = model.get_geometry()
        splats, attrs, _, valid = get_gaussians_from_face(
            model.field, mesh, scale=model.scale, initial_guess=model.initial_guess_bias,
            max_faces=model.max_render_faces)
        return {"means": splats.means[valid], "scales": splats.scales[valid],
                "quats": splats.quats[valid], "opacities": splats.opacities[valid],
                "colors": attrs.kd[valid].abs().clamp(0, 1)}

    def export(self, model):
        from ..models.geosplat_mc import export_stage1

        return export_stage1(model)


# --- stage 2 ---------------------------------------------------------------------


@dataclasses.dataclass
class GeoSplatMCTrainTask(_TrainTaskBase):
    """Stage-2 training task (GeoSplatterMC, GeoSplatMCTrainer). ``load`` is
    the stage-1 run directory (or its export file); the model starts from
    that export, and a resumed run from its own checkpoint."""

    experiment_name: str = "geosplat-mc"
    num_steps_per_val: int = 100
    resolution: int = 96
    scene_scale: float = 1.05
    initial_guess: str = "hybrid"
    num_samples_x: int = 8
    pairs_budget: int | None = None   # see GeoSplatTrainTask.pairs_budget
    tile_shape: str = "16"
    max_render_faces: int = 1 << 18
    load: Path | None = None

    def build(self, dataset, generator):
        from ..models.geosplat import GaussianField, ks_bundle_layout
        from ..models.geosplat_mc import OCC_ENC, GeoSplatterMC
        from ..train.geosplat_mc_trainer import GeoSplatMCTrainer, GeoSplatMCTrainerConfig

        if self.load is None:
            raise ValueError("stage-2 requires --load <stage-1 output dir>")
        export = load_export(find_export(self.load))
        # the field follows the stage-1 roughness predictor it inherits: the
        # hash field for a hash bundle, else a trunk sized by its planes
        bundle = export["ks_enc"]
        field = None
        if ks_bundle_layout(bundle) == "hash":
            field = GaussianField(occ_enc=OCC_ENC, generator=generator, device=dataset.device)
        planes = np.shape(bundle["planes"]) if "planes" in bundle else (3, 512, 512, 32)
        model = GeoSplatterMC(
            resolution=self.resolution, scale=self.scene_scale,
            initial_guess=self.initial_guess, num_samples_x=self.num_samples_x,
            pairs_budget=self.pairs_budget, tile_shape=self.tile_shape,
            max_render_faces=self.max_render_faces, triplane_resolution=planes[1],
            triplane_components=planes[-1], field=field, generator=generator,
            device=dataset.device,
        )
        model.init_from_stage1(export)
        trainer = GeoSplatMCTrainer(
            GeoSplatMCTrainerConfig(num_steps=self.num_steps, batch_size=self.batch_size), model)
        return model, trainer

    def step_fn(self, trainer, cams, gt, generator, step):
        return trainer.train_step(cams, gt, float(step), generator=generator)

    def val_render(self, model, cams):
        # the validation's own draws, the same at every validation: it leaves
        # the training generator (and so a resumed run) untouched
        generator = torch.Generator(device=cams.device).manual_seed(self.seed)
        rgba, _, _ = model.render(cams, kd_perturb_std=0.0, ks_perturb_std=0.0,
                                  generator=generator)
        rgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
        return torch.cat((rgb, rgba[..., 3:]), -1)

    def export(self, model):
        from ..models.geosplat_mc import compact_export

        out = compact_export(model.export_model())
        # the JAX task computes its export in one jitted program, which
        # returns the scalars as float32 / int32 arrays: so does this file
        for k in ("geom_scale", "min_roughness", "max_metallic"):
            out[k] = np.float32(out[k])
        out["resolution"] = np.int32(out["resolution"])
        return out


# --- stage 3 ---------------------------------------------------------------------

# triangles kept per 16x16 tile by the stage-3 mesh raster, at least (the
# model raises it to the frozen mesh's face count): the JAX model's 256
# drops triangles at grid 96 (the frozen s4r-twosphere mesh put up to 459
# into a silhouette tile on the card)
MESH_TILE_CAPACITY = 1024


@dataclasses.dataclass
class GeoSplatDeferTrainTask(_TrainTaskBase):
    """Stage-3 training task (GeoSplatterDefer, GeoSplatDeferTrainer).
    ``load`` is the stage-2 run directory (or its export file); the model
    starts from that export and keeps its geometry frozen. The export is
    ``{"params", "geometry"}``, the surface ``RelightEvalTask`` evaluates."""

    experiment_name: str = "geosplat-defer"
    num_steps: int = 100
    num_steps_per_save: int = 100
    num_steps_per_val: int = 50
    resolution: int = 96
    scene_scale: float = 1.05
    num_samples_x: int = 8
    pairs_budget: int | None = None   # see GeoSplatTrainTask.pairs_budget
    tile_shape: str = "16"
    load: Path | None = None

    def make_model(self, params, device):
        """A GeoSplatterDefer sized for ``params`` (a stage-2 export or a
        stage-3 export's ``params``: the Gaussians and ``ks_enc``)."""
        from ..models.geosplat import check_ks_bundle
        from ..models.geosplat_defer import KS_ENC, GeoSplatterDefer

        hashed = check_ks_bundle(params["ks_enc"]) == "hash"
        planes = (3, 512, 512, 32) if hashed else np.shape(params["ks_enc"]["planes"])
        return GeoSplatterDefer(
            num_gaussians=np.shape(params["means"])[0], ks_resolution=planes[1],
            ks_components=planes[-1], ks_hash=KS_ENC if hashed else None,
            resolution=self.resolution, scale=self.scene_scale,
            num_samples_x=self.num_samples_x, pairs_budget=self.pairs_budget,
            tile_shape=self.tile_shape, mesh_tile_capacity=MESH_TILE_CAPACITY, device=device,
        )

    def build(self, dataset, generator):
        from ..train.geosplat_defer_trainer import (
            GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
        )

        if self.load is None:
            raise ValueError("stage-3 requires --load <stage-2 output dir>")
        self._stage2 = load_export(find_export(self.load))
        model = self.make_model(self._stage2, dataset.device)
        model.init_from_stage2(self._stage2)
        trainer = GeoSplatDeferTrainer(
            GeoSplatDeferTrainerConfig(num_steps=self.num_steps, batch_size=self.batch_size),
            model)
        return model, trainer

    def step_fn(self, trainer, cams, gt, generator, step):
        return trainer.train_step(cams, gt, generator=generator)

    def val_render(self, model, cams):
        # the validation's own draws (see GeoSplatMCTrainTask.val_render)
        generator = torch.Generator(device=cams.device).manual_seed(self.seed)
        rgba, _, _ = model.render(cams, generator=generator)
        rgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
        return torch.cat((rgb, rgba[..., 3:]), -1)

    def vis_splats(self, model):
        # the stage-3 Gaussians are parameters: nothing to compute
        return {"means": model.means, "scales": model.scales, "quats": model.quats,
                "opacities": model.opacities, "colors": model.kd.clamp(0, 1)}

    def export(self, model):
        from ..convert import params_to_numpy
        from ..models.geosplat_defer import frozen_geometry

        # the trained parameters, and the frozen geometry as the stage-2
        # export stored it
        return {"params": params_to_numpy(model.state_dict()),
                "geometry": frozen_geometry(self._stage2)}


# --- mesh-prior variant ----------------------------------------------------------

# the port's one rasterizer backend: the pairs path ("auto" selects it)
BACKENDS = ("auto", "pairs")


@dataclasses.dataclass
class GeoSplatPriorTrainTask(_TrainTaskBase):
    """The mesh-prior variant (GeoSplatterPrior, GeoSplatPriorTrainer):
    ``mesh_path`` is the initial mesh, OBJ or PLY (ascii or binary), whose
    vertices the run offsets. It shades from the shared triplane field, as
    the JAX task does. ``tile_capacity`` is the JAX dense backend's
    per-tile capacity, kept so the presets match; the port's pairs path has
    no such capacity (its budget is ``pairs_budget``). The export is the
    JAX ``export_model``'s, ``sdf`` None."""

    experiment_name: str = "geosplat-prior"
    mesh_path: Path = Path("mesh.obj")
    scene_scale: float = 1.05
    tile_capacity: int = 768
    num_samples_x: int = 8
    backend: str = "auto"
    triplane_resolution: int = 512    # the shared field's (GeoSplatTrainTask)

    def build(self, dataset, generator):
        from ..graphics.mesh import TriangleMesh
        from ..graphics.mesh_io import load_mesh
        from ..models.geosplat_prior import GeoSplatterPrior
        from ..train.geosplat_prior_trainer import (
            GeoSplatPriorTrainer, GeoSplatPriorTrainerConfig,
        )

        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: the port has the pairs path only "
                             f"({BACKENDS})")
        data = load_mesh(self.mesh_path)
        base = TriangleMesh(vertices=torch.from_numpy(data["vertices"]),
                            indices=torch.from_numpy(data["indices"]).long())
        model = GeoSplatterPrior(
            base, scale=self.scene_scale, num_samples_x=self.num_samples_x,
            triplane_resolution=self.triplane_resolution, generator=generator,
            device=dataset.device,
        )
        trainer = GeoSplatPriorTrainer(
            GeoSplatPriorTrainerConfig(num_steps=self.num_steps, batch_size=self.batch_size),
            model)
        return model, trainer

    def step_fn(self, trainer, cams, gt, generator, step):
        return trainer.train_step(cams, gt, generator=generator)

    def val_render(self, model, cams):
        # the validation's own draws (see GeoSplatMCTrainTask.val_render)
        generator = torch.Generator(device=cams.device).manual_seed(self.seed)
        rgba, _, _ = model.render(cams, kd_perturb_std=0.0, ks_perturb_std=0.0,
                                  generator=generator)
        rgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
        return torch.cat((rgb, rgba[..., 3:]), -1)

    def export(self, model):
        return model.export_model()


# --- vanilla 3DGS ----------------------------------------------------------------

# screen pairs budgeted per Gaussian by the 3DGS task (the budget is this x
# N, re-sized as densification changes N). The JAX model's 8 drops ~3/4 of
# the pairs at the presets' start: 65,536 random Gaussians in the unit cube
# at 800 x 800 need 29-32 pairs each from Blender-like cameras, so 48
# leaves a third of headroom
PAIRS_PER_GAUSSIAN = 48
# the 2DGS preset's budgets. 2DGS bins each Gaussian by its circular radius
# (no opacity-aware bounds, no circle prune), so 65,536 random Gaussians in
# the unit cube at 800 x 800 make 48 pairs each and up to 1,876 in one tile
# from Blender-like cameras; 64 pairs and 2,560 a tile leave a third of
# headroom (the JAX model's 8 and 1024 drop pairs and tiles' farthest
# Gaussians without a word)
PAIRS_PER_GAUSSIAN_2DGS = 64
TILE_CAPACITY_2DGS = 2560


@dataclasses.dataclass
class GSplatTrainTask(_TrainTaskBase):
    """Vanilla 3DGS / 2DGS with the densify / cull schedule (GSplatter,
    GSplatTrainer; in ``2dgs`` mode with the regularisers' schedule), from
    ``Splats.random`` in the unit cube. A checkpoint
    holds the Gaussians at their count of that step with their Adam state
    and statistics, so a resume after a densification continues the
    uninterrupted run. The export is the params tree (``means``,
    ``scales``, ``quats``, ``colors``, ``opacities``, ``shs``)."""

    experiment_name: str = "gsplat"
    num_steps: int = 7000
    batch_size: int = 1
    num_steps_per_save: int = 2000
    num_steps_per_val: int = 500
    num_init_gaussians: int = 65536
    sh_degree: int = 3
    rasterize_mode: str = "classic"   # 'classic' | 'antialiased' | '2dgs'
    # the JAX model's 8 overflows at the random init (PAIRS_PER_GAUSSIAN)
    pairs_per_gaussian: int = PAIRS_PER_GAUSSIAN
    # 2dgs only: Gaussians kept per tile (TILE_CAPACITY_2DGS; JAX: 1024)
    tile_capacity: int = TILE_CAPACITY_2DGS

    def build(self, dataset, generator):
        from ..graphics.splats import Splats
        from ..models.gsplatter import GSplatter
        from ..train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

        model = GSplatter(sh_degree=self.sh_degree, rasterize_mode=self.rasterize_mode,
                          tile_capacity=self.tile_capacity,
                          pairs_per_gaussian=self.pairs_per_gaussian, device=dataset.device)
        trainer = GSplatTrainer(
            GSplatTrainerConfig(num_steps=self.num_steps, batch_size=self.batch_size),
            model, dataset_size=dataset.get_size("train"))
        trainer.init_state(Splats.random(self.num_init_gaussians, sh_degree=self.sh_degree,
                                         random_scale=1.0, generator=generator,
                                         device=dataset.device))
        self._trainer = trainer
        return model, trainer

    def step_fn(self, trainer, cams, gt, generator, step):
        return trainer.train_step(cams, gt, max_sh_degree=trainer.max_sh_degree_at(step),
                                  reg_weights=trainer.reg_weights_at(step),
                                  generator=generator)

    def after_update(self, trainer, step, last_wh, generator):
        trainer.after_update(step, last_wh, generator=generator)

    def val_render(self, model, cams):
        splats = self._trainer.splats()
        return torch.stack([model.render_rgba(splats, cams[i])[0] for i in range(len(cams))])

    def vis_splats(self, model):
        return self._trainer.splats()

    def export(self, model):
        from ..convert import splats_to_numpy

        return splats_to_numpy(self._trainer.splats())
