"""Stage-1 GeoSplatter training recipe.

Counterpart of ``geosplatting_tpu/train/geosplat_trainer.py``: per-group
Adam (deform / sdf / weights / kd / ks / z / exposure / light / planes),
initial-guess LR overrides, the vertex-sampling warm-up, linear reg-weight
ramps, SSIM+L1 on random-background-composited linear images plus a 5x mask
MSE, the cubemap gradient x64 and the envmap clamp >= 1e-2 after each step.

The trainer owns the model's optimizer; ``train_step`` updates the model in
place and returns the step's metrics as 0-d tensors. Randomness is explicit:
the per-pixel background and the field jitter noise may be passed in as
tensors, else they are drawn from the caller's ``torch.Generator``.
``train_step_dp`` is the step of one rank of a data-parallel group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..models.geosplat import GeoSplatter
from ..ops.ssim import ssim_l1_loss
from ..parallel.sharding import rank_and_world, shard_batch, shard_range
from . import dp
from .grad_utils import sanitize
from .optim import GroupOptimizers, ModelTrainerState, OptimizerSpec


@dataclasses.dataclass(frozen=True)
class GeoSplatTrainerConfig:
    num_steps: int = 500
    batch_size: int = 8
    cov3d_lr: float = 3e-3
    geometry_lr: float = 1e-2
    appearance_lr: float = 3e-3
    light_lr: float = 1e-2
    base_decay: int | None = 800
    base_eps: float = 1e-15
    vertex_sample_warmup: int = 50
    light_reg_begin: float = 2e-3
    light_reg_end: float = 2e-3
    light_reg_decay: int = 500
    sdf_reg_begin: float = 0.2
    sdf_reg_end: float = 0.12
    sdf_reg_decay: int = 500
    kd_grad_reg_begin: float = 0.0
    kd_grad_reg_end: float = 0.03
    kd_grad_reg_decay: int = 500
    kd_perturb_std: float = 0.01
    ks_grad_reg_begin: float = 0.0
    ks_grad_reg_end: float = 0.001
    ks_grad_reg_decay: int = 500
    ks_perturb_std: float = 0.01
    use_mask_loss: bool = True
    light_grad_scale: float = 64.0


def _ramp(begin: float, end: float, decay: int, step: float) -> float:
    """Linear ramp from begin to end over ``decay`` steps (float32)."""
    f32 = np.float32
    if decay <= 0:
        return float(f32(begin))
    t = np.minimum(f32(1.0), f32(step) / f32(decay))
    return float(f32(begin) - (f32(begin) - f32(end)) * t)


class GeoSplatTrainer(ModelTrainerState):
    def __init__(self, config: GeoSplatTrainerConfig, model: GeoSplatter):
        # the reference trains in f32 at 'highest' precision, but cuDNN's
        # convolutions (the SSIM blur) run in TF32 by default on the card;
        # both switches are process-wide
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.model = model
        c = config
        geometry_lr = c.geometry_lr
        light_lr = c.light_lr
        if model.initial_guess == "specular":
            geometry_lr *= 5
            light_lr *= 3
        elif model.initial_guess == "glossy":
            light_lr *= 3
        self.reg_overrides = {}
        if model.initial_guess == "specular":
            self.reg_overrides = {"kd_grad_begin": 0.5, "ks_grad_begin": 0.1}

        def mk(lr):
            return OptimizerSpec(lr=lr, eps=c.base_eps, lr_decay=c.base_decay)

        specs = {
            "deform": mk(geometry_lr),
            "sdf": mk(geometry_lr),
            "weights": mk(geometry_lr),
            "kd": mk(c.appearance_lr),
            "ks": mk(c.appearance_lr * 0.5),
            "z": mk(c.cov3d_lr),
            "exposure": mk(light_lr * 0.5),
            "light": mk(light_lr),
        }
        groups = self.param_groups()
        if "planes" in groups:   # the shared triplane trunk (the hash field has none)
            specs["planes"] = mk(c.appearance_lr)
        self.optimizers = GroupOptimizers(specs, groups)

    def param_groups(self) -> dict[str, list[torch.nn.Parameter]]:
        m = self.model
        return {
            "deform": [m.deform],
            "sdf": [m.sdf],
            "weights": [m.weights],
            "exposure": [m.exposure],
            "light": [m.cubemap],
            **m.field.param_groups(),
        }

    def reg_weights(self, step: float) -> dict:
        c = self.config
        kd_begin = self.reg_overrides.get("kd_grad_begin", c.kd_grad_reg_begin)
        ks_begin = self.reg_overrides.get("ks_grad_begin", c.ks_grad_reg_begin)
        return {
            "light": _ramp(c.light_reg_begin, c.light_reg_end, c.light_reg_decay, step),
            "sdf": _ramp(c.sdf_reg_begin, c.sdf_reg_end, c.sdf_reg_decay, step),
            "kd_grad": _ramp(kd_begin, c.kd_grad_reg_end, c.kd_grad_reg_decay, step),
            "ks_grad": _ramp(ks_begin, c.ks_grad_reg_end, c.ks_grad_reg_decay, step),
        }

    def _local_loss(self, cameras, gt_rgba, bg, rw, sampling, jitter_noise, generator):
        c = self.config
        rgba, reg, aux = self.model.render(
            cameras, reg_weights=rw, kd_perturb_std=c.kd_perturb_std,
            ks_perturb_std=c.ks_perturb_std, sampling=sampling,
            jitter_noise=jitter_noise, generator=generator,
        )
        # loss in linear space with a per-pixel random background
        gt_linear = gimages.srgb2rgb(gt_rgba[..., :3])
        mask = gt_rgba[..., 3:]
        img1 = rgba[..., :3] + (1 - rgba[..., 3:]) * bg
        img2 = gt_linear * mask + (1 - mask) * bg
        loss = ssim_l1_loss(img1, img2)
        if c.use_mask_loss:
            loss = loss + 5.0 * ((mask - rgba[..., 3:]) ** 2).mean()
        with torch.no_grad():  # sRGB-space MSE for the PSNR metric
            pred_srgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
            mse = ((pred_srgb - gt_rgba[..., :3] * mask) ** 2).mean()
        return loss + reg, (loss.detach(), mse, reg.detach()), aux

    def compute_grads(
        self,
        cameras: Cameras,
        gt_rgba: torch.Tensor,              # [B, H, W, 4] sRGB-encoded rgba
        step: float,
        *,
        sampling: str = "face",
        background: torch.Tensor | None = None,   # [B, H, W, 3] uniform
        jitter_noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ):
        """Forward and backward of the stage-1 loss; leaves every parameter's
        raw gradient in ``.grad``. Returns ((loss, mse, reg), aux)."""
        if background is None:
            background = torch.rand(
                gt_rgba[..., :3].shape, generator=generator, device=gt_rgba.device
            )
        rw = self.reg_weights(step)
        self.model.zero_grad(set_to_none=False)
        with record_function("trainer.forward"):
            total, parts, aux = self._local_loss(
                cameras, gt_rgba, background, rw, sampling, jitter_noise, generator
            )
        with record_function("trainer.backward"):
            total.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return parts, aux

    def train_step(self, cameras: Cameras, gt_rgba: torch.Tensor, step: float, *,
                   sampling: str = "face", background: torch.Tensor | None = None,
                   jitter_noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        (loss, mse, reg), aux = self.compute_grads(
            cameras, gt_rgba, step, sampling=sampling, background=background,
            jitter_noise=jitter_noise, generator=generator,
        )
        with record_function("trainer.apply_grads"):
            return self._apply_grads(loss, mse, reg, aux)

    def train_step_dp(self, cameras: Cameras, gt_rgba: torch.Tensor, step: float, *,
                      sampling: str = "face", group=None,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Camera-batch data-parallel step (``train/dp.py``; JAX
        ``train_step_dp``). ``cameras`` and ``gt_rgba`` are the whole batch,
        the same on every rank of ``group``, and so is ``generator``'s
        state: the rank draws the whole batch's background, renders its
        shard of the cameras, and the gradients and metrics are reduced over
        the ranks before the update (``nonfinite_grads`` counts after the
        reduce). Equal to ``train_step`` on the whole batch up to float
        reassociation; ``dp_reduce_bytes`` is what the gradients' all-reduce
        moved."""
        rank, world = rank_and_world(group)
        shard_range(len(cameras), rank, world)   # an indivisible batch raises before a draw
        background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                device=gt_rgba.device)
        cams, gt, bg = shard_batch((cameras, gt_rgba, background), rank, world)
        parts, aux = self.compute_grads(cams, gt, step, sampling=sampling, background=bg,
                                        generator=generator)
        with record_function("trainer.dp_reduce"):
            nbytes = dp.reduce_grads(self.model.parameters(), group)
            (loss, mse, reg), aux = dp.reduce_aux(parts, aux, group)
        with record_function("trainer.apply_grads"):
            return {**self._apply_grads(loss, mse, reg, aux), "dp_reduce_bytes": nbytes}

    @torch.no_grad()
    def _apply_grads(self, loss, mse, reg, aux) -> dict[str, torch.Tensor]:
        m = self.model
        exposure = torch.exp(m.exposure[0]).clone()
        m.cubemap.grad.mul_(self.config.light_grad_scale)  # cubemap grad x64 hook
        nonfinite = sanitize(p.grad for ps in self.param_groups().values() for p in ps)
        self.optimizers.step()
        m.cubemap.clamp_(min=1e-2)  # envmap clamp
        return {
            "nonfinite_grads": nonfinite,
            "loss": loss,
            "reg": reg,
            "splat_psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "num_gaussians": aux["num_gaussians"],
            "num_surf_cubes": aux["num_surf_cubes"],
            "num_surf_edges": aux["num_surf_edges"],
            # budget-overflow observables: > 1 means silent truncation
            "pair_fill": aux["total_pairs"] / max(aux["max_pairs"], 1),
            "face_fill": aux["num_faces_valid"] / max(aux["max_render_faces"], 1),
            "exposure": exposure,
        }

    def sampling_at(self, step: int) -> str:
        warmup = self.config.vertex_sample_warmup
        return "vertex" if warmup > 0 and step < warmup else "face"
