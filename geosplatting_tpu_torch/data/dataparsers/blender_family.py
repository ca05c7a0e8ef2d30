"""Blender-style dataparsers: Blender and MaskedBlender (the NeRF-synthetic
layout, PNG frames).

Counterpart of ``geosplatting_tpu/data/dataparsers/blender_family.py``
(``ParsedSplit``, ``_load_transforms``, ``_focal``, ``BlenderDataparser``,
``MaskedBlenderDataparser``). Parsers give numpy camera and image stacks;
the dataset puts them on the device. The Syn4Relight, TensoIR and Shiny
Blender layouts are recognised by ``data.dataset`` but not parsed yet.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np

from ..io import load_masked_image, resize_image

IMAGE_WH = 800


@dataclasses.dataclass(frozen=True)
class ParsedSplit:
    c2w: np.ndarray        # [N, 3, 4]
    focal: float
    width: int
    height: int
    near: float
    far: float
    image_paths: list      # loaded lazily
    alpha_color: tuple | None = None
    meta: Any = None

    def load_images(self, scale_factor: float | None = None) -> np.ndarray:
        """[N, H, W, 4] rgba float32 (LDR values as stored, i.e. sRGB)."""
        out = []
        for p in self.image_paths:
            img = load_masked_image(p)
            if scale_factor is not None:
                img = resize_image(img, scale_factor)
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
class MaskedBlenderDataparser:
    """Blender layout with the RGBA alpha kept as the mask (selected
    explicitly: the layout is Blender's)."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        return _blender_split(path, split)

    recognize = staticmethod(BlenderDataparser.recognize)
