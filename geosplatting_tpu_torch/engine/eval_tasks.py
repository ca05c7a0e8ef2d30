"""Evaluation of a stage-3 model: novel views, relighting and material
recovery.

Counterpart of ``geosplatting_tpu/engine/eval_tasks.py``
(``render_chunked``, ``estimate_albedo_scaling``, ``image_metrics``,
``RelightEvaler``, ``_mean_metrics``): per-channel albedo scaling against
the ground-truth albedo (least squares or median), PSNR / SSIM of the test
views, of the frames relit under each ground-truth environment (albedo
scaled, occ collapsed) and of the scaled albedo, and the roughness MSE;
LPIPS (``ops/lpips.py``) where ``GEOSPLAT_LPIPS_WEIGHTS`` names a weights
file, else ``None``, as in the JAX package.

Deviations from the JAX package: the ground-truth maps and relit frames
are resized by the dataset's ``scale_factor``, as its images are, so a
scene evaluates at a reduced resolution too; and a relight environment
that exists but cannot be decoded raises (naming
``OPENCV_IO_ENABLE_OPENEXR`` for an ``.exr``), where the JAX evaluator
skips it without a word (``except Exception``). Only a missing
environment file is skipped.

Every camera of a chunk sees the same shade draws in every render kind, as
the JAX package's one fixed key gives them: by default a generator seeded
with ``seed`` at each chunk; ``shade_draws`` replaces them (the parity tests
replay the JAX draws).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..models.geosplat_defer import GeoSplatterDefer
from ..ops.envshade import ShadeDraws
from ..ops.lpips import lpips
from ..ops.ssim import ssim

CHUNK = 8


@torch.no_grad()
def render_chunked(render_fn: Callable[[Cameras], torch.Tensor], cameras: Cameras,
                   chunk: int = CHUNK) -> np.ndarray:
    """``render_fn`` over the cameras in chunks of ``chunk``, gradient-free;
    the outputs stacked as one numpy array."""
    n = len(cameras)
    chunk = max(1, min(chunk, n))
    return np.concatenate([render_fn(cameras[s:s + chunk]).cpu().numpy()
                           for s in range(0, n, chunk)])


def estimate_albedo_scaling(model: GeoSplatterDefer, cameras: Cameras, gt_albedos,
                            *, method: str = "least-square") -> torch.Tensor:
    """Per-channel scale [3] that maps the rendered kd (linear, alpha-
    composited over black) to the sRGB ground-truth albedos [N, H, W, 4]:
    the mean of each view's least-squares scale, or the median of each
    view's median ratio over its masked pixels."""
    kd_all = torch.as_tensor(render_chunked(lambda cb: model.render_attribute(cb, "kd"),
                                            cameras))
    gt_albedos = torch.as_tensor(np.asarray(gt_albedos), dtype=torch.float32)
    scalings = []
    for i in range(len(cameras)):
        kd_rgba, gt = kd_all[i], gt_albedos[i]
        albedo = kd_rgba[..., :3].clamp(0, 1) * kd_rgba[..., 3:]
        if method == "least-square":
            gt_lin = gimages.srgb2rgb(gt[..., :3]) * gt[..., 3:]
            num = (albedo * gt_lin).reshape(-1, 3).sum(0)
            den = torch.clamp((albedo ** 2).reshape(-1, 3).sum(0), min=1e-8)
            scalings.append(num / den)
        elif method == "median":
            gt_lin = gimages.srgb2rgb(gt[..., :3])
            ratio = (gt_lin / torch.clamp(albedo, min=1e-3)).numpy()[gt[..., 3].numpy() > 0]
            scalings.append(torch.as_tensor(np.median(ratio, axis=0)))
        else:
            raise ValueError(method)
    s = torch.stack(scalings)
    return s.mean(0) if method == "least-square" else torch.as_tensor(np.median(s.numpy(), 0))


_LPIPS_WARNED = False


def image_metrics(pred, gt, fast: bool = False) -> dict:
    """PSNR of two images in [0, 1]; unless ``fast``, SSIM and LPIPS too.
    LPIPS is None when ``GEOSPLAT_LPIPS_WEIGHTS`` names no weights file."""
    pred = torch.as_tensor(np.asarray(pred), dtype=torch.float32)
    gt = torch.as_tensor(np.asarray(gt), dtype=torch.float32)
    mse = float(((pred - gt) ** 2).mean())
    out = {"psnr": -10.0 * np.log10(max(mse, 1e-12))}
    if not fast:
        out["ssim"] = float(ssim(pred, gt))
        try:
            out["lpips"] = lpips(pred, gt)
        except FileNotFoundError as err:
            global _LPIPS_WARNED
            if not _LPIPS_WARNED:
                _LPIPS_WARNED = True
                reason = ("weights absent — set GEOSPLAT_LPIPS_WEIGHTS to a vgg16+lin .npz "
                          "to enable (graph validated in tests/test_torch_lpips.py)"
                          if not os.environ.get("GEOSPLAT_LPIPS_WEIGHTS") else str(err))
                print(f"lpips: {reason}; reporting lpips: null", flush=True)
            out["lpips"] = None
    return out


@dataclasses.dataclass
class RelightEvaler:
    """NVS, relighting and material metrics over a Syn4Relight test split."""

    model: GeoSplatterDefer
    scaling: str = "least-square"
    fast: bool = True
    skip_nvs: bool = False
    skip_rlit: bool = False
    skip_mat: bool = False
    seed: int = 0
    shade_draws: list[ShadeDraws] | None = None   # per position in a chunk

    def _draws(self, cams: Cameras) -> list[ShadeDraws]:
        if self.shade_draws is not None:
            return [d.to(self.model.device) for d in self.shade_draws[:len(cams)]]
        generator = torch.Generator(device=self.model.device).manual_seed(self.seed)
        return [self.model.draw_shade(cams, generator) for _ in range(len(cams))]

    def _render_srgb(self, cams: Cameras, **kw) -> torch.Tensor:
        rgba, _, _ = self.model.render(cams, draws=self._draws(cams), **kw)
        rgb = gimages.rgb2srgb(rgba[..., :3].clamp(0, 1))
        return (rgb * rgba[..., 3:]).clamp(0, 1)    # over a black background

    def run(self, dataset) -> dict[str, Any]:
        from ..data.io import load_float32_image, load_masked_image, resize_image

        cams, gt_images, meta = dataset.get_split("test")
        sf = getattr(dataset, "scale_factor", None)

        def load_map(path):
            img = load_masked_image(path)
            return img if sf is None else resize_image(img, sf)

        results: dict[str, Any] = {}
        model = self.model

        gt_albedos, scale = None, None
        if meta and meta.get("albedo"):
            gt_albedos = np.stack([load_map(p) for p in meta["albedo"]])
            scale = estimate_albedo_scaling(model, cams, gt_albedos, method=self.scaling)
            results["albedo_scaling"] = scale.tolist()
            scale = scale.to(model.device)

        def over_black(img):
            return np.clip(img[..., :3] * img[..., 3:], 0, 1)

        if not self.skip_nvs:
            preds = render_chunked(self._render_srgb, cams)
            results["nvs"] = _mean_metrics([image_metrics(preds[i], over_black(gt_images[i]),
                                                          self.fast) for i in range(len(cams))])

        if not self.skip_rlit and meta and meta.get("relight"):
            for name, frames in meta["relight"].items():
                try:
                    env = load_float32_image(meta["envmaps"][name])[..., :3]
                except FileNotFoundError:
                    continue
                env = torch.as_tensor(env, device=model.device)
                preds = render_chunked(
                    lambda cb: self._render_srgb(cb, relight_envmap=env, albedo_scaling=scale),
                    cams[:len(frames)])
                results[f"relight/{name}"] = _mean_metrics([
                    image_metrics(preds[i], over_black(load_map(f)), self.fast)
                    for i, f in enumerate(frames)])

        if not self.skip_mat and gt_albedos is not None:
            gt_roughs = ([load_map(p) for p in meta["roughness"]]
                         if meta.get("roughness") else None)
            kd_all = render_chunked(
                lambda cb: model.render_attribute(cb, "kd", albedo_scaling=scale), cams)
            ks_all = render_chunked(lambda cb: model.render_attribute(cb, "ks"), cams) \
                if gt_roughs is not None else None
            vals, rough_mses = [], []
            for i in range(len(cams)):
                albedo = np.clip(kd_all[i][..., :3], 0, 1) * kd_all[i][..., 3:]
                vals.append(image_metrics(albedo, over_black(gt_albedos[i]), self.fast))
                if gt_roughs is not None:
                    gt_r = gt_roughs[i][..., 0:1] * gt_roughs[i][..., 3:4]
                    rough_mses.append(float(np.mean((ks_all[i][..., 1:2] - gt_r) ** 2)))
            results["albedo"] = _mean_metrics(vals)
            if rough_mses:
                results["roughness_mse"] = float(np.mean(rough_mses))
        return results


def _mean_metrics(vals: list[dict]) -> dict:
    out = {}
    for k in vals[0]:
        xs = [v[k] for v in vals if v[k] is not None]
        out[k] = float(np.mean(xs)) if xs else None
    return out
