"""Mesh-prior GeoSplatterPrior training recipe.

Counterpart of ``geosplatting_tpu/train/geosplat_prior_trainer.py``: seven
Adam groups (the vertex offsets ``deform`` at 1e-4, kd and occ at the
appearance lr, ks at 0.2x it, z at the cov3d lr, exposure at half and the
latlng light at the light lr) plus any group of the field's not named
(the shared trunk's ``planes``), the constant occ and smoothness weights,
SSIM-L1 in linear space on random-background composites plus a 5x mask
MSE, the latlng gradient x64, and the latlng clamp >= 1e-3 after each
update. The direct ``kdks`` / ``zs`` parameters of the non-jitter mode
belong to no group, as in the JAX trainer: they are never updated.

``train_step`` is the JAX package's ``train_step_accum``: forward and
backward one camera at a time, the gradients summed in ``.grad``, then
scaled by 1/B before Adam. What is not passed in is drawn from the caller's
``torch.Generator`` for the whole batch before the first camera, in this
order: the per-pixel background, the field's jitter noise, the visibility
grid's surface draws, then each camera's ``ShadeDraws``; each camera takes
its slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..models.geosplat_prior import GeoSplatterPrior
from ..ops.envshade import ShadeDraws
from ..ops.ssim import ssim_l1_loss
from .grad_utils import sanitize
from .optim import GroupOptimizers, ModelTrainerState, OptimizerSpec


@dataclasses.dataclass(frozen=True)
class GeoSplatPriorTrainerConfig:
    num_steps: int = 500
    batch_size: int = 8
    geometry_lr: float = 1e-4
    cov3d_lr: float = 3e-3
    appearance_lr: float = 1e-2
    light_lr: float = 1e-2
    base_decay: int | None = 800
    base_eps: float = 1e-15
    occ_weight: float = 1e-3
    kd_grad_reg: float = 0.03
    ks_grad_reg: float = 0.03
    kd_perturb_std: float = 0.01
    ks_perturb_std: float = 0.01
    use_mask_loss: bool = True
    light_grad_scale: float = 64.0


class GeoSplatPriorTrainer(ModelTrainerState):
    def __init__(self, config: GeoSplatPriorTrainerConfig, model: GeoSplatterPrior):
        # f32 convolutions in the SSIM blur (cuDNN defaults to TF32 on the card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.model = model
        c = config

        def spec(lr):
            return OptimizerSpec(lr=lr, eps=c.base_eps, lr_decay=c.base_decay)

        specs = {
            "deform": spec(c.geometry_lr),
            "kd": spec(c.appearance_lr),
            "occ": spec(c.appearance_lr),
            "ks": spec(c.appearance_lr * 0.2),
            "z": spec(c.cov3d_lr),
            "exposure": spec(c.light_lr * 0.5),
            "light": spec(c.light_lr),
        }
        for extra in model.field.param_groups():
            specs.setdefault(extra, spec(c.appearance_lr))
        self.optimizers = GroupOptimizers(specs, self.param_groups())

    def param_groups(self) -> dict[str, list[torch.nn.Parameter]]:
        m = self.model
        return {"deform": [m.deform], "exposure": [m.exposure], "light": [m.latlng],
                **m.field.param_groups()}

    def reg_weights(self) -> dict:
        c = self.config
        return {"occ": c.occ_weight, "kd_grad": c.kd_grad_reg, "ks_grad": c.ks_grad_reg}

    def _local_loss(self, cameras, gt_rgba, bg, jitter_noise, surface_draws, draws):
        """One camera slice's loss: every term is a per-camera mean, so the
        cameras' mean is the batch's loss."""
        c = self.config
        rgba, reg, aux = self.model.render(
            cameras, reg_weights=self.reg_weights(), kd_perturb_std=c.kd_perturb_std,
            ks_perturb_std=c.ks_perturb_std, jitter_noise=jitter_noise,
            surface_draws=surface_draws, draws=draws,
        )
        gt_linear = gimages.srgb2rgb(gt_rgba[..., :3])
        mask = gt_rgba[..., 3:]
        img1 = rgba[..., :3] + (1 - rgba[..., 3:]) * bg
        img2 = gt_linear * mask + (1 - mask) * bg
        loss = ssim_l1_loss(img1, img2)
        if c.use_mask_loss:
            loss = loss + 5.0 * ((mask - rgba[..., 3:]) ** 2).mean()
        return loss + reg, (loss.detach(), reg.detach()), aux

    def compute_grads(
        self,
        cameras: Cameras,
        gt_rgba: torch.Tensor,                    # [B, H, W, 4] sRGB-encoded rgba
        *,
        background: torch.Tensor | None = None,   # [B, H, W, 3] uniform
        jitter_noise: torch.Tensor | None = None,  # field.jitter_shape standard normal
        surface_draws: tuple | None = None,       # draw_visibility's
        draws: list[ShadeDraws] | None = None,     # one per camera
        generator: torch.Generator | None = None,
    ):
        """Forward and backward of each camera's loss in turn; leaves the
        sum of the cameras' gradients in ``.grad``. Returns the per-camera
        sums (loss, reg) and the aux with each entry's largest value."""
        m = self.model
        c = self.config
        if background is None:
            background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                    device=gt_rgba.device)
        if jitter_noise is None and m.smooth_type == "jitter" and (
                c.kd_perturb_std > 0 or c.ks_perturb_std > 0):
            jitter_noise = torch.randn(m.field.jitter_shape(m.num_faces),
                                       generator=generator, device=m.device)
        if surface_draws is None and m.shadow_scale > 0:
            surface_draws = m.draw_visibility(generator)
        if draws is None:
            draws = [m.draw_shade(generator) for _ in range(len(cameras))]
        m.zero_grad(set_to_none=False)
        sums, aux = None, None
        for i in range(len(cameras)):
            with record_function("trainer.forward"):
                total, parts, aux_i = self._local_loss(
                    cameras[i:i + 1], gt_rgba[i:i + 1], background[i:i + 1], jitter_noise,
                    surface_draws, draws[i:i + 1])
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

    def train_step(self, cameras: Cameras, gt_rgba: torch.Tensor, *,
                   background: torch.Tensor | None = None,
                   jitter_noise: torch.Tensor | None = None,
                   surface_draws: tuple | None = None,
                   draws: list[ShadeDraws] | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One step over the camera batch (the prior's weights are constant
        and its schedules count updates, so no step is passed)."""
        (loss, reg), aux = self.compute_grads(
            cameras, gt_rgba, background=background, jitter_noise=jitter_noise,
            surface_draws=surface_draws, draws=draws, generator=generator,
        )
        with record_function("trainer.apply_grads"):
            inv = 1.0 / len(cameras)
            with torch.no_grad():
                for p in self.model.parameters():
                    p.grad.mul_(inv)
            return self._apply_grads(loss * inv, reg * inv, aux)

    @torch.no_grad()
    def _apply_grads(self, loss, reg, aux) -> dict[str, torch.Tensor]:
        m = self.model
        m.latlng.grad.mul_(self.config.light_grad_scale)
        nonfinite = sanitize(p.grad for ps in self.param_groups().values() for p in ps)
        self.optimizers.step()
        m.latlng.clamp_(min=1e-3)
        return {
            "nonfinite_grads": nonfinite,
            "loss": loss,
            "reg": reg,
            "num_gaussians": aux["num_gaussians"],
            # budget-overflow observable: > 1 means silent truncation
            "pair_fill": aux["total_pairs"] / max(aux["max_pairs"], 1),
        }
