"""Blender-style dataparsers: Blender, MaskedBlender and DepthBlender (the
NeRF-synthetic layout, PNG frames), Syn4Relight (HDR training frames with
masks, relit test frames and material maps), TensoIR (z-up poses,
``_sunset.png`` frames) and Shiny Blender (no val split).

Counterpart of ``geosplatting_tpu/data/dataparsers/blender_family.py``
(``ParsedSplit``, ``_load_transforms``, ``_focal``, ``BlenderDataparser``,
``DepthBlenderDataparser``, ``MaskedBlenderDataparser``, ``_srgb_encode``,
``_exr_or_hdr``, ``Syn4RelightDataparser``, ``TensoIRDataparser`` and
``ShinyBlenderDataparser``). Parsers give numpy camera and image stacks;
the dataset puts them on the device.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np

from ..io import load_float32_image, load_masked_image, resize_image

IMAGE_WH = 800


def _srgb_encode(x: np.ndarray) -> np.ndarray:
    """The exact sRGB OETF in numpy (``graphics.images.rgb2srgb``'s curve)."""
    return np.where(
        x <= 0.0031308, x * 12.92, 1.055 * np.power(np.maximum(x, 1e-12), 1 / 2.4) - 0.055
    ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ParsedSplit:
    c2w: np.ndarray        # [N, 3, 4]
    focal: float
    width: int
    height: int
    near: float
    far: float
    image_paths: list      # loaded lazily
    mask_paths: list | None = None
    alpha_color: tuple | None = None
    meta: Any = None
    # per-camera intrinsics [N] (real captures, rendered layouts); where set
    # they replace the one focal and the centred principal point
    fx: np.ndarray | None = None
    fy: np.ndarray | None = None
    cx: np.ndarray | None = None
    cy: np.ndarray | None = None
    # images a parser makes itself (DepthBlender's depth and alpha, the
    # rendered views of the mesh layouts)
    images: np.ndarray | None = None
    # a parser's own resize, on top of the dataset's scale_factor (IDR and
    # Stanford-ORB store full-size files with intrinsics of the resized ones)
    image_scale: float | None = None
    # linear HDR frames (.exr / .hdr) are clipped to [0, 1] and sRGB-encoded
    # at load, so every split holds the sRGB values the trainers expect
    hdr_to_srgb: bool = False

    def _total_scale(self, scale_factor: float | None) -> float | None:
        if self.image_scale is None and scale_factor is None:
            return None
        return (self.image_scale or 1.0) * (scale_factor or 1.0)

    def load_images(self, scale_factor: float | None = None) -> np.ndarray:
        """[N, H, W, 4] rgba float32 (LDR values as stored, i.e. sRGB),
        resized by ``image_scale`` x ``scale_factor``; a parser's own
        ``images`` resized the same way, given an alpha of 1 where they have
        three channels."""
        total = self._total_scale(scale_factor)
        if self.images is not None:
            img = self.images
            if total is not None:
                img = np.stack([resize_image(im, total) for im in img])
            if img.shape[-1] == 3:
                img = np.concatenate((img, np.ones_like(img[..., :1])), axis=-1)
            return img
        out = []
        for i, p in enumerate(self.image_paths):
            img = load_masked_image(p, self.mask_paths[i] if self.mask_paths else None)
            if self.hdr_to_srgb and Path(p).suffix.lower() in (".exr", ".hdr"):
                img = np.concatenate(
                    (_srgb_encode(np.clip(img[..., :3], 0.0, 1.0)), img[..., 3:]), axis=-1)
            if total is not None:
                img = resize_image(img, total)
            if self.alpha_color is not None and img.shape[-1] == 4:
                a = img[..., 3:]
                rgb = img[..., :3] * a + np.asarray(self.alpha_color) * (1 - a)
                img = np.concatenate((rgb, a), axis=-1)
            out.append(img)
        return np.stack(out)


def _load_transforms(path: Path, split: str):
    with open(path / f"transforms_{split}.json") as f:
        meta = json.load(f)
    poses = np.array([f_["transform_matrix"] for f_ in meta["frames"]], dtype=np.float32)
    return meta, poses[:, :3, :]


def _focal(meta: dict, width: int) -> float:
    return 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))


def _blender_split(path: Path, split: str, **kw) -> ParsedSplit:
    meta, c2w = _load_transforms(path, split)
    c2w = c2w.copy()
    c2w[:, :, 3] *= 2 / 3
    return ParsedSplit(
        c2w=c2w, focal=_focal(meta, IMAGE_WH),
        width=IMAGE_WH, height=IMAGE_WH, near=4 / 3, far=4.0,
        image_paths=[path / (f_["file_path"] + ".png") for f_ in meta["frames"]], **kw,
    )


@dataclasses.dataclass(frozen=True)
class BlenderDataparser:
    """NeRF-synthetic layout; RGBA frames composited on ``alpha_color``."""

    alpha_color: str = "black"

    def parse(self, path: Path, split: str) -> ParsedSplit:
        color = (1.0, 1.0, 1.0) if self.alpha_color == "white" else (0.0, 0.0, 0.0)
        return _blender_split(path, split, alpha_color=color)

    @staticmethod
    def recognize(path: Path) -> bool:
        return all(
            (path / p).exists()
            for p in ("train", "test", "transforms_train.json",
                      "transforms_test.json", "transforms_val.json")
        )


@dataclasses.dataclass(frozen=True)
class DepthBlenderDataparser:
    """Blender layout for depth supervision: images [N, H, W, 2] = (metric
    depth = red x 4, alpha); ``meta`` names ``gt.ply`` where it exists.
    Selected explicitly (the layout is Blender's)."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        base = _blender_split(path, split)
        imgs = np.stack([load_float32_image(p) for p in base.image_paths])
        alpha = imgs[..., 3:4] if imgs.shape[-1] >= 4 else np.ones_like(imgs[..., :1])
        gt_mesh = path / "gt.ply"
        return dataclasses.replace(
            base, image_paths=[],
            images=np.concatenate((imgs[..., :1] * 4.0, alpha), -1).astype(np.float32),
            meta={"gt_mesh": gt_mesh if gt_mesh.exists() else None, "mesh_scale": 2 / 3})

    @staticmethod
    def recognize(path: Path) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class MaskedBlenderDataparser:
    """Blender layout with the RGBA alpha kept as the mask (selected
    explicitly: the layout is Blender's)."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        return _blender_split(path, split)

    recognize = staticmethod(BlenderDataparser.recognize)


def _exr_or_hdr(p: Path) -> Path:
    """An S4R file stored as ``.exr``, or its Radiance ``.hdr`` twin (the
    synthetic S4R-layout scenes write ``.hdr``): the one that exists."""
    return p if p.exists() else p.with_suffix(".hdr")


@dataclasses.dataclass(frozen=True)
class Syn4RelightDataparser:
    """Synthetic4Relight: stored poses mapped by rows (-y, z, -x) and a 2/3
    translation scale; train frames ``<frame>_rgb.exr`` (linear HDR) with
    ``<frame>_mask.png``; test frames ``<frame>_rgba.png`` with a ``meta`` of
    the albedo and roughness maps, the frames relit under ``envmap6`` and
    ``envmap12`` (``test_rli/``) and those environments' files. The val
    split is the train split."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        split = "train" if split == "val" else split
        meta, c2w = _load_transforms(path, split)
        c2w = np.stack((-c2w[:, 1, :], c2w[:, 2, :], -c2w[:, 0, :]), axis=-2)
        c2w[:, :, 3] *= 2 / 3
        frames = meta["frames"]
        base = dict(c2w=c2w, focal=_focal(meta, IMAGE_WH), width=IMAGE_WH, height=IMAGE_WH,
                    near=4 / 3, far=4.0)
        if split == "test":
            names = [f_["file_path"].rsplit("/", 1)[-1] for f_ in frames]
            return ParsedSplit(
                **base, image_paths=[path / (f_["file_path"] + "_rgba.png") for f_ in frames],
                meta={
                    "albedo": [path / (f_["file_path"] + "_albedo.png") for f_ in frames],
                    "roughness": [path / (f_["file_path"] + "_rough.png") for f_ in frames],
                    "relight": {
                        env: [path / "test_rli" / f"{env}_{n}.png" for n in names]
                        for env in ("envmap6", "envmap12")
                    },
                    "envmaps": {env: _exr_or_hdr(path.parent / f"{env}.exr")
                                for env in ("envmap6", "envmap12")},
                },
            )
        return ParsedSplit(
            **base,
            image_paths=[_exr_or_hdr(path / (f_["file_path"] + "_rgb.exr")) for f_ in frames],
            mask_paths=[path / (f_["file_path"] + "_mask.png") for f_ in frames],
            hdr_to_srgb=True,
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        return all((path / p).exists() for p in (
            "train", "test", "transforms_train.json", "transforms_test.json")) and all(
            _exr_or_hdr(path.parent / n).exists() for n in ("envmap6.exr", "envmap12.exr"))


@dataclasses.dataclass(frozen=True)
class TensoIRDataparser:
    """TensoIR-synthetic: translations scaled by 2/3, then the z-up poses
    mapped by rows (-y, z, -x); frames ``<file_path>_sunset.png``."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        base = _blender_split(path, split)
        meta, _ = _load_transforms(path, split)
        c2w = base.c2w
        return dataclasses.replace(
            base, c2w=np.stack((-c2w[:, 1, :], c2w[:, 2, :], -c2w[:, 0, :]), axis=-2),
            image_paths=[path / (f_["file_path"] + "_sunset.png") for f_ in meta["frames"]])

    @staticmethod
    def recognize(path: Path) -> bool:
        if not (path / "transforms_train.json").exists():
            return False
        with open(path / "transforms_train.json") as f:
            first = json.load(f)["frames"][0]["file_path"]
        return (path / (first + "_sunset.png")).exists()


@dataclasses.dataclass(frozen=True)
class ShinyBlenderDataparser:
    """Shiny Blender: the Blender layout without a val transforms file (the
    val split is the train split)."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        return _blender_split(path, "train" if split == "val" else split)

    @staticmethod
    def recognize(path: Path) -> bool:
        return ((path / "transforms_train.json").exists()
                and (path / "transforms_test.json").exists()
                and not (path / "transforms_val.json").exists()
                and not (path.parent / "envmap6.exr").exists())
