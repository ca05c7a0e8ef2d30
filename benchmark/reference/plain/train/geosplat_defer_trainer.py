"""Stage-3 GeoSplatterDefer training recipe.

Counterpart of ``geosplatting_tpu/train/geosplat_defer_trainer.py``: eight
Adam groups (light hue and value, exposure, the Gaussians' means, scales,
quats, normals and opacities) and, unless ``fix_material``, three more (kd,
the roughness predictor, occ), with 3DGS-style relative learning rates and
the exp decay on the light, exposure, means and normals; SSIM-L1 in linear
space on random-background composites (and optionally a 5x mask MSE), the
ks jitter regularization, the edge-aware kd (and normal) smoothness against
the ground truth, the light gradients x64, and the clamps of ``latlng_hue``
and ``kd`` to [0.01, 0.99] after each update.

``train_step`` is the JAX package's ``train_step_accum``: forward and
backward one camera at a time, the gradients summed in ``.grad``, then
scaled by 1/B before Adam. Every camera's render sees the step's one ks
jitter noise and its own ``ShadeDraws``; what is not passed in is drawn
from the caller's ``torch.Generator``: the per-pixel background, then the
jitter noise, then each camera's draws. ``train_step_dp`` is the step of
one rank of a data-parallel group.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..graphics import gmath
from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..models.geosplat_defer import GeoSplatterDefer
from ..ops.envshade import ShadeDraws
from ..ops.ssim import ssim_l1_loss
from ..parallel.sharding import rank_and_world, shard_batch, shard_range
from . import dp
from .grad_utils import sanitize
from .optim import GroupOptimizers, ModelTrainerState, OptimizerSpec


@dataclasses.dataclass(frozen=True)
class GeoSplatDeferTrainerConfig:
    num_steps: int = 100
    batch_size: int = 8
    base_lr: float = 1e-3
    light_lr: float = 1e-3
    base_decay: int | None = 500
    base_eps: float = 1e-15
    fix_material: bool = False
    kd_reg: float = 0.2
    ks_reg: float = 0.05
    normal_reg: float = 0.0
    use_mask_loss: bool = False
    light_grad_scale: float = 64.0


def _edge_aware(pred_maps: torch.Tensor, gt_comp: torch.Tensor) -> torch.Tensor:
    """Mean |gradient| of the predicted maps, weighted by exp(-|gradient|)
    of the ground truth, along x and along y."""
    def grads(x):
        return (gmath.abs_(x[:, :, 1:] - x[:, :, :-1]), gmath.abs_(x[:, 1:, :] - x[:, :-1, :]))

    px, py = grads(pred_maps)
    gx, gy = grads(gt_comp)
    return (px * torch.exp(-gx)).mean() + (py * torch.exp(-gy)).mean()


class GeoSplatDeferTrainer(ModelTrainerState):
    def __init__(self, config: GeoSplatDeferTrainerConfig, model: GeoSplatterDefer):
        # f32 convolutions in the SSIM blur (cuDNN defaults to TF32 on the card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.model = model
        c = config

        def spec(lr, decay=None):
            return OptimizerSpec(lr=lr, eps=c.base_eps, lr_decay=decay)

        specs = {
            "light_hue": spec(c.light_lr, c.base_decay),
            "light_value": spec(c.light_lr, c.base_decay),
            "exposure": spec(c.light_lr * 0.5, c.base_decay),
            "means": spec(c.base_lr * 0.16, c.base_decay),
            "scales": spec(c.base_lr * 5),
            "quats": spec(c.base_lr),
            "normals": spec(c.base_lr, c.base_decay),
            "opacities": spec(c.base_lr * 50),
        }
        if not c.fix_material:
            specs["kd"] = spec(c.base_lr * 5)
            specs["ks"] = spec(c.base_lr * 0.5)
            specs["occ"] = spec(c.base_lr * 2.5)
        self.optimizers = GroupOptimizers(specs, self.param_groups())

    def param_groups(self) -> dict[str, list[torch.nn.Parameter]]:
        m = self.model
        groups = {
            "light_hue": [m.latlng_hue], "light_value": [m.latlng_value],
            "exposure": [m.exposure], "means": [m.means], "scales": [m.scales],
            "quats": [m.quats], "normals": [m.normals], "opacities": [m.opacities],
        }
        if not self.config.fix_material:
            groups.update(kd=[m.kd], ks=list(m.ks_enc.parameters()), occ=[m.occ])
        return groups

    def _local_loss(self, cameras, gt_rgba, bg, jitter_noise, draws, generator):
        c = self.config
        rgba, reg, aux = self.model.render(cameras, ks_weight=c.ks_reg,
                                           jitter_noise=jitter_noise, draws=draws,
                                           generator=generator)
        gt_clamped = gt_rgba.clamp(0, 1)
        gt_linear = gimages.srgb2rgb(gt_clamped[..., :3])
        mask = gt_clamped[..., 3:]
        img1 = rgba[..., :3] + (1 - rgba[..., 3:]) * bg
        img2 = gt_linear * mask + (1 - mask) * bg
        loss = ssim_l1_loss(img1, img2)
        if c.use_mask_loss:
            loss = loss + 5.0 * ((mask - rgba[..., 3:]) ** 2).mean()
        if c.kd_reg > 0 or c.normal_reg > 0:
            gt_comp = gt_linear * mask + (1 - mask)
            if c.kd_reg > 0:
                kd_maps = self.model.render_attribute(cameras, "kd")
                reg = reg + _edge_aware(kd_maps[..., :3], gt_comp) * c.kd_reg
            if c.normal_reg > 0:
                n_maps = self.model.render_attribute(cameras, "normal")
                reg = reg + _edge_aware(n_maps[..., :3], gt_comp) * c.normal_reg
        with torch.no_grad():  # sRGB-space MSE for the PSNR metric
            pred_srgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1)) * rgba[..., 3:]
            mse = ((pred_srgb - gt_clamped[..., :3] * mask) ** 2).mean()
        return loss + reg, (loss.detach(), mse, reg.detach()), aux

    def _draw_jitter(self, generator: torch.Generator | None) -> torch.Tensor | None:
        m = self.model
        if self.config.ks_reg > 0:
            return torch.randn(m.means.shape, generator=generator, device=m.device)
        return None

    def compute_grads(
        self,
        cameras: Cameras,
        gt_rgba: torch.Tensor,               # [B, H, W, 4] sRGB-encoded rgba
        *,
        background: torch.Tensor | None = None,   # [B, H, W, 3] uniform
        jitter_noise: torch.Tensor | None = None,  # [N, 3] standard normal
        draws: list[ShadeDraws] | None = None,     # one per camera
        generator: torch.Generator | None = None,
    ):
        """Forward and backward of each camera's loss in turn; leaves the
        sum of the cameras' gradients in ``.grad``. Returns the per-camera
        sums ((loss, mse, reg), aux with each entry's largest value)."""
        m = self.model
        if background is None:
            background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                    device=gt_rgba.device)
        if jitter_noise is None:
            jitter_noise = self._draw_jitter(generator)
        m.zero_grad(set_to_none=False)
        sums, aux = None, None
        for i in range(len(cameras)):
            with record_function("trainer.forward"):
                total, parts, aux_i = self._local_loss(
                    cameras[i:i + 1], gt_rgba[i:i + 1], background[i:i + 1], jitter_noise,
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

    def train_step(self, cameras: Cameras, gt_rgba: torch.Tensor, *,
                   background: torch.Tensor | None = None,
                   jitter_noise: torch.Tensor | None = None,
                   draws: list[ShadeDraws] | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        (loss, mse, reg), aux = self.compute_grads(
            cameras, gt_rgba, background=background, jitter_noise=jitter_noise, draws=draws,
            generator=generator,
        )
        with record_function("trainer.apply_grads"):
            inv = 1.0 / len(cameras)
            with torch.no_grad():
                for p in self.model.parameters():
                    p.grad.mul_(inv)
            return self._apply_grads(loss * inv, mse * inv, reg * inv, aux)

    def train_step_dp(self, cameras: Cameras, gt_rgba: torch.Tensor, *, group=None,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Camera-batch data-parallel step (``train/dp.py``; JAX
        ``train_step_dp``), as ``GeoSplatMCTrainer.train_step_dp``: the
        whole batch's background, ks jitter and per-camera ``ShadeDraws``
        drawn on every rank (its own cameras' draws kept), the mean of its
        cameras' gradients, then the reduce over the ranks and the update.
        The frozen geometry is the model's, the same on every rank."""
        m = self.model
        rank, world = rank_and_world(group)
        lo, hi = shard_range(len(cameras), rank, world)
        background = torch.rand(gt_rgba[..., :3].shape, generator=generator,
                                device=gt_rgba.device)
        jitter_noise = self._draw_jitter(generator)
        draws = []
        for i in range(len(cameras)):
            d = m.draw_shade(cameras[i], generator)
            if lo <= i < hi:
                draws.append(d)
        cams, gt, bg = shard_batch((cameras, gt_rgba, background), rank, world)
        sums, aux = self.compute_grads(cams, gt, background=bg, jitter_noise=jitter_noise,
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
        m.latlng_hue.grad.mul_(self.config.light_grad_scale)
        m.latlng_value.grad.mul_(self.config.light_grad_scale)
        nonfinite = sanitize(p.grad for ps in self.param_groups().values() for p in ps)
        self.optimizers.step()
        m.latlng_hue.clamp_(0.01, 0.99)
        m.kd.clamp_(0.01, 0.99)
        return {
            "nonfinite_grads": nonfinite,
            "loss": loss,
            "reg": reg,
            "splat_psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "num_gaussians": aux["num_gaussians"],
            # budget-overflow observables: > 1 means silent truncation
            "pair_fill": aux["total_pairs"] / max(aux["max_pairs"], 1),
            "mesh_tile_fill": aux["mesh_tile_fill"],
            "mesh_pair_fill": aux["mesh_pair_fill"],
            "exposure": exposure,
        }
