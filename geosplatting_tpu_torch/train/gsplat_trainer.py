"""Vanilla 3DGS / 2DGS training recipe: per-group Adam, the SH-degree
schedule, the 2DGS regularisers' schedule and the densify / cull /
opacity-reset schedule with its optimizer surgery.

Counterpart of ``geosplatting_tpu/train/gsplat_trainer.py``
(``GSplatTrainerConfig`` with the JAX defaults, ``GSplatTrainer``:
``init_state``, ``train_step``, ``max_sh_degree_at``, ``reg_weights_at``,
``after_update``). The trainer holds the Gaussians as one ``nn.Parameter``
per field, their Adam state and the densification statistics
``xys_grad_norm`` and ``vis_counts``; ``after_update`` replaces the
parameters when the Gaussian count changes and re-indexes the Adam moments
through the ``param_map`` (``GroupOptimizers.mutate_params``). In ``2dgs``
mode the loss adds the normal-consistency and distortion terms at the
weights ``reg_weights_at`` gives for the step.

Randomness is explicit: the training background and the split's normal
draws come from the caller's ``torch.Generator`` or are passed in.
``train_step_dp`` is the step of one rank of a data-parallel group.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..graphics.cameras import Cameras
from ..graphics.splats import FIELDS, Splats, cull, densify_and_cull
from ..models.gsplatter import GSplatter
from ..parallel.sharding import all_reduce_, rank_and_world, shard_batch
from . import dp
from .losses import ssim_l1_loss
from .optim import GroupOptimizers, OptimizerSpec


@dataclasses.dataclass(frozen=True)
class GSplatTrainerConfig:
    num_steps: int = 7000
    batch_size: int = 1
    base_lr: float = 1e-3
    base_eps: float = 1e-15
    pos_lr_decay: int = 4500
    warmup_length: int = 500
    refine_every: int = 100
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    num_splits: int = 2
    sh_degree_interval: int = 1000
    stop_split_at: int = 15000
    ssim_lambda: float = 0.2
    # the 2DGS regularisers, on from their start step in '2dgs' mode only
    normal_weight: float = 5e-2
    normal_weight_start: int = 7000
    distort_weight: float = 1e-2
    distort_weight_start: int = 3000


class GSplatTrainer:
    def __init__(self, config: GSplatTrainerConfig, model: GSplatter, dataset_size: int):
        # the reference trains in f32 at 'highest' precision, but cuDNN's
        # convolutions (the SSIM blur) run in TF32 by default on the card
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.model = model
        self.dataset_size = dataset_size
        c = config
        self.specs = {
            "means": OptimizerSpec(lr=c.base_lr * 0.16, eps=c.base_eps, lr_decay=c.pos_lr_decay),
            "scales": OptimizerSpec(lr=c.base_lr * 5, eps=c.base_eps),
            "quats": OptimizerSpec(lr=c.base_lr, eps=c.base_eps),
            "colors": OptimizerSpec(lr=c.base_lr * 2.5, eps=c.base_eps),
            "opacities": OptimizerSpec(lr=c.base_lr * 50, eps=c.base_eps),
        }
        if model.sh_degree > 0:
            self.specs["shs"] = OptimizerSpec(lr=c.base_lr * 0.125, eps=c.base_eps)
        self.params: dict[str, torch.nn.Parameter] = {}

    # ---- state ---------------------------------------------------------------
    def init_state(self, splats: Splats) -> None:
        """Parameters from ``splats``, fresh Adam groups and statistics."""
        self.params = {k: torch.nn.Parameter(getattr(splats, k).detach().clone())
                       for k in FIELDS}
        self.optimizers = GroupOptimizers(self.specs,
                                          {k: [self.params[k]] for k in self.specs})
        self._reset_stats()

    def _reset_stats(self) -> None:
        n = self.params["means"].shape[0]
        device = self.params["means"].device
        self.xys_grad_norm = torch.zeros(n, device=device)
        self.vis_counts = torch.ones(n, device=device)

    def splats(self) -> Splats:
        return Splats(**self.params)

    def state_dict(self) -> dict:
        """What a checkpoint holds: the parameters at their current count,
        the Adam state, the update count and the statistics."""
        return {
            "params": {k: p.detach().clone() for k, p in self.params.items()},
            **self.optimizers.state_dict(),
            "xys_grad_norm": self.xys_grad_norm.clone(),
            "vis_counts": self.vis_counts.clone(),
        }

    def load_state_dict(self, state: dict) -> None:
        device = self.params["means"].device
        self.init_state(Splats(**{k: v.to(device) for k, v in state["params"].items()}))
        self.optimizers.load_state_dict(state)
        self.xys_grad_norm = state["xys_grad_norm"].to(device)
        self.vis_counts = state["vis_counts"].to(device)

    # ---- the step --------------------------------------------------------------
    def train_step(self, cameras: Cameras, gt_rgba: torch.Tensor, *,
                   max_sh_degree: int | None,
                   reg_weights: tuple[float, float] = (0.0, 0.0),
                   background: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One update from a batch of cameras and their [B, H, W, 4] rgba
        images: SSIM-L1 against the images composited on the background
        (in ``2dgs`` mode plus ``reg_weights`` = (normal, distortion)
        weights times the mean over the cameras of 1 - sum(normal x
        pseudo normal x alpha) and of the distortion), the densification
        statistics of every camera, Adam. Returns the metrics as 0-d
        tensors."""
        return self._step(cameras, gt_rgba, max_sh_degree, reg_weights, background, generator)

    def train_step_dp(self, cameras: Cameras, gt_rgba: torch.Tensor, *,
                      max_sh_degree: int | None,
                      reg_weights: tuple[float, float] = (0.0, 0.0), group=None,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """The step of one rank of a data-parallel group (``train/dp.py``):
        ``cameras`` and ``gt_rgba`` are the whole batch, the same on every
        rank, and so is ``generator``'s state (the step's background). The
        rank renders its shard; the gradients are reduced to their mean over
        the ranks, the densification statistics summed over the ranks (each
        camera's screen-position gradient weighed as in the whole batch's
        loss, 1/B), the losses averaged and the fills taken at their largest,
        all before the update; ``after_update`` then decides alike on every
        rank. Equal to ``train_step`` on the whole batch up to float
        reassociation."""
        rank, world = rank_and_world(group)
        cams, gt = shard_batch((cameras, gt_rgba), rank, world)
        return self._step(cams, gt, max_sh_degree, reg_weights, None, generator,
                          group=group, world=world)

    def _step(self, cameras, gt_rgba, max_sh_degree, reg_weights, background, generator,
              group=None, world: int = 1) -> dict[str, torch.Tensor]:
        is_2dgs = self.model.rasterize_mode == "2dgs"
        normal_w, distort_w = reg_weights
        if background is None:
            background = self.model.get_background_color(True, generator)
        gt_rgb = torch.clamp(gt_rgba[..., :3] + (1 - gt_rgba[..., 3:4]) * background, 0, 1)
        splats = self.splats()
        n = splats.num_gaussians
        for p in self.params.values():
            p.grad = None
        offsets, rgbs, radii, fills, tile_fills, n_losses, d_losses = [], [], [], [], [], [], []
        with record_function("gsplat.forward"):
            if self.model.camera_batching == "vmap":
                # one [B, N, 2] hook: its gradient is every camera's at once
                off = torch.zeros((len(cameras), n, 2), device=splats.means.device,
                                  requires_grad=True)
                rgba, info = self.model.render_rgba_batched(
                    splats, cameras, max_sh_degree=max_sh_degree, means2d_offset=off)
                offsets, radii = [off], list(info["radii"])
                rgbs = list(rgba[..., :3] + (1.0 - rgba[..., 3:4]) * background)
                fills.append(info["total_pairs"] / max(info["max_pairs"], 1))
            else:
                for i in range(len(cameras)):
                    off = torch.zeros((n, 2), device=splats.means.device, requires_grad=True)
                    rgb, info = self.model.render_rgb(splats, cameras[i], background,
                                                      max_sh_degree=max_sh_degree,
                                                      means2d_offset=off)
                    offsets.append(off)
                    rgbs.append(rgb)
                    radii.append(info["radii"])
                    fills.append(info["total_pairs"] / max(info["max_pairs"], 1))
                    if is_2dgs:
                        # normal consistency and distortion (gsplat_trainer.py:135-139)
                        n_losses.append((1.0 - (info["normal"] * (info["pseudo_normal"]
                                                                  * info["alpha_map"])).sum(-1)
                                         ).mean())
                        d_losses.append(info["distort"].mean())
                        tile_fills.append(info["max_tile_pairs"] / info["tile_capacity"])
            rgbs = torch.stack(rgbs)
            loss = ssim_l1_loss(rgbs, gt_rgb, ssim_lambda=self.config.ssim_lambda)
            if is_2dgs:
                normal_loss = torch.stack(n_losses).mean()
                distort_loss = torch.stack(d_losses).mean()
                loss = loss + normal_w * normal_loss + distort_w * distort_loss
        with record_function("gsplat.backward"):
            loss.backward()
        with torch.no_grad(), record_function("gsplat.update"):
            # densification statistics (gsplat_trainer.py:166-170)
            visible = (torch.stack(radii) > 0).float()                        # [B, N]
            grad_norm = torch.linalg.norm(torch.cat([o.grad.reshape(-1, n, 2) for o in offsets]),
                                          dim=-1)
            # a rank's loss weighs its cameras 1 / (B / world), the batch's 1 / B
            stats = torch.stack(((grad_norm / world * visible).sum(0), visible.sum(0)))
            for k in self.specs:   # an unused group still takes its (zero) update, as in optax
                if self.params[k].grad is None:
                    self.params[k].grad = torch.zeros_like(self.params[k])
            nbytes = None
            if world > 1:
                all_reduce_(stats, group=group)
                nbytes = dp.reduce_grads([self.params[k] for k in self.specs], group)
            self.xys_grad_norm += stats[0]
            self.vis_counts += stats[1]
            nonfinite = sum(int((~torch.isfinite(self.params[k].grad)).sum())
                            for k in self.specs)
            self.optimizers.step()
            mse = torch.mean((rgbs - gt_rgb) ** 2)
        metrics = {
            "loss": loss.detach(),
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "nonfinite_grads": torch.tensor(nonfinite),
            # > 1 means the pair budget dropped the farthest Gaussians' pairs
            "pair_fill": torch.stack(fills).max(),
            "num_gaussians": torch.tensor(n),
        }
        if is_2dgs:
            metrics.update(
                normal_loss=normal_loss.detach(), distort_loss=distort_loss.detach(),
                # > 1 means the tile capacity cut a tile's farthest Gaussians
                tile_fill=torch.stack(tile_fills).max())
        if nbytes is not None:
            means = [k for k in ("loss", "normal_loss", "distort_loss") if k in metrics]
            maxes = [k for k in ("pair_fill", "tile_fill") if k in metrics]
            reduced, top = dp.reduce_aux((*(metrics[k] for k in means), mse),
                                         {k: metrics[k] for k in maxes}, group)
            metrics.update(zip(means, reduced[:-1]), **top, dp_reduce_bytes=nbytes,
                           psnr=-10.0 * torch.log10(torch.clamp(reduced[-1], min=1e-12)))
        return metrics

    # ---- host-side schedule ----------------------------------------------------
    def max_sh_degree_at(self, step: int) -> int:
        return min(step // self.config.sh_degree_interval, self.model.sh_degree)

    def reg_weights_at(self, step: int) -> tuple[float, float]:
        """(normal, distortion) weights of the 2DGS regularisers at a step."""
        c = self.config
        return (c.normal_weight if step >= c.normal_weight_start else 0.0,
                c.distort_weight if step >= c.distort_weight_start else 0.0)

    @torch.no_grad()
    def _apply_map(self, new: Splats, param_map: torch.Tensor) -> None:
        """Install ``new`` as the parameters; re-index every group's Adam
        moments through ``param_map``; restart the statistics."""
        self.params = {k: torch.nn.Parameter(getattr(new, k).contiguous()) for k in FIELDS}
        for k in self.specs:
            self.optimizers.mutate_params(k, [self.params[k]], param_map=param_map)
        self._reset_stats()

    @torch.no_grad()
    def after_update(self, step: int, last_wh: tuple[int, int], *,
                     generator: torch.Generator | None = None,
                     randn: torch.Tensor | None = None) -> dict | None:
        """The densify / cull / opacity-reset schedule
        (gsplat_trainer.py:199-259). Returns None where the step changes
        nothing, else ``{"param_map": [N_new] or None, "reset_opacities":
        bool}``. ``randn`` replaces the split's normal draws."""
        c = self.config
        if step <= c.warmup_length or step % c.refine_every != 0:
            return None
        reset_interval = c.reset_alpha_every * c.refine_every
        splats = Splats(**{k: p.detach() for k, p in self.params.items()})
        scale_thresh = (c.cull_scale_thresh
                        if step > c.refine_every * c.reset_alpha_every else None)
        param_map = None
        if step < c.stop_split_at and step % reset_interval > self.dataset_size + c.refine_every:
            new, param_map = densify_and_cull(
                splats, xys_grad_norm=self.xys_grad_norm, vis_counts=self.vis_counts,
                last_wh=last_wh, densify_grad_thresh=c.densify_grad_thresh,
                densify_size_thresh=c.densify_size_thresh, num_splits=c.num_splits,
                cull_alpha_thresh=c.cull_alpha_thresh, cull_scale_thresh=scale_thresh,
                generator=generator, randn=randn)
            self._apply_map(new, param_map)
        elif step >= c.stop_split_at and c.continue_cull_post_densification:
            new, param_map = cull(splats, cull_alpha_thresh=c.cull_alpha_thresh,
                                  cull_scale_thresh=scale_thresh)
            self._apply_map(new, param_map)
        reset = step < c.stop_split_at and step % reset_interval == c.refine_every
        if reset:
            self.params["opacities"].copy_(
                self.splats().reset_opacities(c.cull_alpha_thresh * 2.0).opacities)
            self.optimizers.mutate_params("opacities", clear=True)
        return {"param_map": param_map, "reset_opacities": reset}
