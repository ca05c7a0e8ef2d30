"""Stage-2 GeoSplatterMC training recipe.

Counterpart of ``geosplatting_tpu/train/geosplat_mc_trainer.py``: nine Adam
groups plus the shared trunk's ``planes`` (the geometry groups warm up for
``geometry_warm_up`` steps, ``ks`` takes 0.2x the appearance lr), the
linear sdf ramp and constant occ / smoothness weights, SSIM-L1 in linear
space on random-background composites plus a 5x mask MSE, the latlng
gradient x64 and the latlng clamp >= 1e-3 after each update.

``train_step`` is the JAX package's ``train_step_accum``: forward and
backward one camera at a time (the Monte-Carlo shading keeps too much for
the whole batch at once), the gradients summed in ``.grad``, then scaled by
1/B before Adam. Every camera's render sees the step's one jitter noise and
its own ``ShadeDraws``; what is not passed in is drawn from the caller's
``torch.Generator``: the per-pixel background, then the jitter noise, then
each camera's draws. ``train_step_dp`` is the step of one rank of a
data-parallel group.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..models.geosplat_mc import GeoSplatterMC
from ..ops.envshade import ShadeDraws
from ..ops.ssim import ssim_l1_loss
from ..parallel.sharding import rank_and_world, shard_batch, shard_range
from . import dp
from .geosplat_trainer import _ramp
from .grad_utils import sanitize
from .optim import GroupOptimizers, ModelTrainerState, OptimizerSpec


@dataclasses.dataclass(frozen=True)
class GeoSplatMCTrainerConfig:
    num_steps: int = 500
    batch_size: int = 8
    cov3d_lr: float = 3e-3
    geometry_lr: float = 3e-3
    appearance_lr: float = 1e-2
    light_lr: float = 1e-2
    base_decay: int | None = 800
    base_eps: float = 1e-15
    geometry_warm_up: int = 50
    sdf_reg_begin: float = 0.2
    sdf_reg_end: float = 0.01
    sdf_reg_decay: int = 500
    occ_weight: float = 1e-3
    kd_grad_reg: float = 0.03
    ks_grad_reg: float = 0.03
    kd_perturb_std: float = 0.01
    ks_perturb_std: float = 0.01
    use_mask_loss: bool = True
    light_grad_scale: float = 64.0


class GeoSplatMCTrainer(ModelTrainerState):
    def __init__(self, config: GeoSplatMCTrainerConfig, model: GeoSplatterMC):
        # f32 convolutions in the SSIM blur (cuDNN defaults to TF32 on the card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.model = model
        c = config

        def spec(lr, warm_up=None):
            return OptimizerSpec(lr=lr, eps=c.base_eps, lr_decay=c.base_decay, warm_up=warm_up)

        specs = {
            "deform": spec(c.geometry_lr, c.geometry_warm_up),
            "weights": spec(c.geometry_lr, c.geometry_warm_up),
            "sdf": spec(c.geometry_lr, c.geometry_warm_up),
            "kd": spec(c.appearance_lr),
            "occ": spec(c.appearance_lr),
            "ks": spec(c.appearance_lr * 0.2),
            "z": spec(c.cov3d_lr),
            "exposure": spec(c.light_lr * 0.5),
            "light": spec(c.light_lr),
        }
        groups = self.param_groups()
        if "planes" in groups:   # the shared triplane trunk (the hash field has none)
            specs["planes"] = spec(c.appearance_lr)
        self.optimizers = GroupOptimizers(specs, groups)

    def param_groups(self) -> dict[str, list[torch.nn.Parameter]]:
        m = self.model
        return {
            "deform": [m.deform],
            "weights": [m.weights],
            "sdf": [m.sdf],
            "exposure": [m.exposure],
            "light": [m.latlng],
            **m.field.param_groups(),
        }

    def reg_weights(self, step: float) -> dict:
        c = self.config
        return {
            "sdf": _ramp(c.sdf_reg_begin, c.sdf_reg_end, c.sdf_reg_decay, step),
            "occ": c.occ_weight,
            "kd_grad": c.kd_grad_reg,
            "ks_grad": c.ks_grad_reg,
        }

    def _local_loss(self, cameras, gt_rgba, bg, rw, jitter_noise, draws, generator):
        c = self.config
        rgba, reg, aux = self.model.render(
            cameras, reg_weights=rw, kd_perturb_std=c.kd_perturb_std,
            ks_perturb_std=c.ks_perturb_std, jitter_noise=jitter_noise, draws=draws,
            generator=generator,
        )
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

    def _draw_jitter(self, generator: torch.Generator | None) -> torch.Tensor | None:
        m, c = self.model, self.config
        if m.smooth_type == "jitter" and (c.kd_perturb_std > 0 or c.ks_perturb_std > 0):
            return torch.randn(m.field.jitter_shape(m.num_field_points()),
                               generator=generator, device=m.device)
        return None

    def compute_grads(
        self,
        cameras: Cameras,
        gt_rgba: torch.Tensor,               # [B, H, W, 4] sRGB-encoded rgba
        step: float,
        *,
        background: torch.Tensor | None = None,   # [B, H, W, 3] uniform
        jitter_noise: torch.Tensor | None = None,  # field.jitter_shape standard normal
        draws: list[ShadeDraws] | None = None,     # one per camera
        generator: torch.Generator | None = None,
    ):
        """Forward and backward of each camera's loss in turn; leaves the
        sum of the cameras' gradients in ``.grad``. Returns the per-camera
        sums ((loss, mse, reg), aux with each entry's largest value)."""
        m = self.model
        c = self.config
        if background is None:
            background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                    device=gt_rgba.device)
        if jitter_noise is None:
            jitter_noise = self._draw_jitter(generator)
        rw = self.reg_weights(step)
        m.zero_grad(set_to_none=False)
        sums, aux = None, None
        for i in range(len(cameras)):
            with record_function("trainer.forward"):
                total, parts, aux_i = self._local_loss(
                    cameras[i:i + 1], gt_rgba[i:i + 1], background[i:i + 1], rw, jitter_noise,
                    None if draws is None else draws[i:i + 1], generator,
                )
            with record_function("trainer.backward"):
                total.backward()
            sums = parts if sums is None else tuple(a + b for a, b in zip(sums, parts))
            aux = aux_i if aux is None else {
                k: torch.maximum(v, aux_i[k]) if isinstance(v, torch.Tensor) else max(v, aux_i[k])
                for k, v in aux.items()}
        for p in m.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return sums, aux

    def train_step(self, cameras: Cameras, gt_rgba: torch.Tensor, step: float, *,
                   background: torch.Tensor | None = None,
                   jitter_noise: torch.Tensor | None = None,
                   draws: list[ShadeDraws] | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        (loss, mse, reg), aux = self.compute_grads(
            cameras, gt_rgba, step, background=background, jitter_noise=jitter_noise,
            draws=draws, generator=generator,
        )
        with record_function("trainer.apply_grads"):
            inv = 1.0 / len(cameras)
            with torch.no_grad():
                for p in self.model.parameters():
                    p.grad.mul_(inv)
            return self._apply_grads(loss * inv, mse * inv, reg * inv, aux)

    def train_step_dp(self, cameras: Cameras, gt_rgba: torch.Tensor, step: float, *,
                      group=None,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Camera-batch data-parallel step (``train/dp.py``; JAX
        ``train_step_dp``). ``cameras`` and ``gt_rgba`` are the whole batch,
        the same on every rank of ``group``, and so is ``generator``'s
        state. The rank draws what ``train_step`` draws for the whole batch
        (the background, the jitter noise, every camera's ``ShadeDraws``,
        keeping only its own cameras' draws), takes the mean of its
        cameras' gradients, and the gradients and metrics are reduced over
        the ranks before the update. Equal to ``train_step`` on the whole
        batch up to float reassociation."""
        m = self.model
        rank, world = rank_and_world(group)
        lo, hi = shard_range(len(cameras), rank, world)
        background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                device=gt_rgba.device)
        jitter_noise = self._draw_jitter(generator)
        draws = []
        for i in range(len(cameras)):
            d = m.draw_shade(generator)
            if lo <= i < hi:
                draws.append(d)
        cams, gt, bg = shard_batch((cameras, gt_rgba, background), rank, world)
        sums, aux = self.compute_grads(cams, gt, step, background=bg, jitter_noise=jitter_noise,
                                       draws=draws, generator=generator)
        inv = 1.0 / len(cams)
        with torch.no_grad():
            for p in m.parameters():
                p.grad.mul_(inv)
        with record_function("trainer.dp_reduce"):
            nbytes = dp.reduce_grads(m.parameters(), group)
            (loss, mse, reg), aux = dp.reduce_aux(tuple(x * inv for x in sums), aux, group)
        with record_function("trainer.apply_grads"):
            return {**self._apply_grads(loss, mse, reg, aux), "dp_reduce_bytes": nbytes}

    @torch.no_grad()
    def _apply_grads(self, loss, mse, reg, aux) -> dict[str, torch.Tensor]:
        m = self.model
        exposure = torch.exp(m.exposure[0]).clone()
        m.latlng.grad.mul_(self.config.light_grad_scale)
        nonfinite = sanitize(p.grad for ps in self.param_groups().values() for p in ps)
        self.optimizers.step()
        m.latlng.clamp_(min=1e-3)
        return {
            "nonfinite_grads": nonfinite,
            "loss": loss,
            "reg": reg,
            "splat_psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "num_gaussians": aux["num_gaussians"],
            # budget-overflow observables: > 1 means silent truncation
            "pair_fill": aux["total_pairs"] / max(aux["max_pairs"], 1),
            "face_fill": aux["num_faces_valid"] / max(aux["max_render_faces"], 1),
            "exposure": exposure,
        }
