"""Dataset orchestration: layout recognition, split caching and the shuffled
batch iterator of the train loop.

Counterpart of ``geosplatting_tpu/data/dataset.py``. A split's cameras live
on the dataset's device; its images are parsed once into one numpy stack
and copied to the device once, as one tensor, so each batch is a gather
there. ``iter_batches`` draws its order from
``np.random.default_rng(seed).permutation`` as the JAX package does, so
both give the same batches.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from .. import _kernels
from ..graphics.cameras import Cameras
from .dataparsers.blender_family import (
    BlenderDataparser, ParsedSplit, ShinyBlenderDataparser, Syn4RelightDataparser,
    TensoIRDataparser,
)

# StanfordORB comes before Blender in the JAX package's recognition order
# and is not ported yet: it is recognised so that it is named, never parsed
# as another layout.


def _is_stanford_orb(path: Path) -> bool:
    needed = ("train", "train_mask", "test", "test_mask", "transforms_train.json",
              "transforms_test.json", "transforms_novel.json")
    return (all((path / p).exists() for p in needed) and path.parent.name == "blender_LDR"
            and (path.parent.parent / "ground_truth" / path.name).exists())


# (name, recognizer, parser class or None while not ported), in the JAX
# package's recognition order
DATAPARSERS = (
    ("Syn4Relight", Syn4RelightDataparser.recognize, Syn4RelightDataparser),
    ("TensoIR", TensoIRDataparser.recognize, TensoIRDataparser),
    ("StanfordORB", _is_stanford_orb, None),
    ("Blender", BlenderDataparser.recognize, BlenderDataparser),
    ("ShinyBlender", ShinyBlenderDataparser.recognize, ShinyBlenderDataparser),
)


def recognize_dataparser(path: Path):
    """The parser of the first layout (in the JAX package's order) that
    ``path`` has; raises NotImplementedError naming a layout the port does
    not read yet."""
    path = Path(path)
    for name, recognize, cls in DATAPARSERS:
        if recognize(path):
            if cls is None:
                raise NotImplementedError(
                    f"{path} is a {name} dataset; its dataparser is not ported yet")
            return cls()
    raise ValueError(
        f"no dataparser recognizes {path} (the port reads the Blender, Syn4Relight, "
        "TensoIR and Shiny Blender layouts; IDR, LLFF, COLMAP and the synthetic-mesh "
        "layouts are not ported yet)")


def cameras_of(parsed: ParsedSplit, scale_factor: float | None, device) -> Cameras:
    """A parsed split's cameras, intrinsics scaled by ``scale_factor``
    (computed in float64, stored float32, as the JAX package does)."""
    sf = scale_factor or 1.0
    n = parsed.c2w.shape[0]

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return Cameras(
        c2w=f32(parsed.c2w),
        fx=f32(np.full((n,), parsed.focal) * sf),
        fy=f32(np.full((n,), parsed.focal) * sf),
        cx=f32(np.full((n,), parsed.width / 2.0) * sf),
        cy=f32(np.full((n,), parsed.height / 2.0) * sf),
        width=int(parsed.width * sf), height=int(parsed.height * sf),
        near=parsed.near, far=parsed.far,
    )


@dataclasses.dataclass
class Dataset:
    path: Path
    scale_factor: float | None = None
    dataparser: Any = None
    device: str | torch.device | None = None

    def __post_init__(self):
        self.path = Path(self.path)
        self.device = _kernels.resolve_device(self.device)
        if self.dataparser is None:
            self.dataparser = recognize_dataparser(self.path)
        self._cache: dict[str, tuple[Cameras, np.ndarray, Any]] = {}
        self._dev_cache: dict[str, torch.Tensor] = {}

    def get_split(self, split: str) -> tuple[Cameras, np.ndarray, Any]:
        """(cameras [N] on the device, rgba images [N, H, W, 4] numpy, meta)."""
        if split not in self._cache:
            parsed: ParsedSplit = self.dataparser.parse(self.path, split)
            images = parsed.load_images(self.scale_factor)
            cams = cameras_of(parsed, self.scale_factor, self.device)
            self._cache[split] = (cams, images, parsed.meta)
        return self._cache[split]

    def get_size(self, split: str) -> int:
        return len(self.get_split(split)[0])

    def device_images(self, split: str) -> torch.Tensor:
        """All of a split's images as one float32 tensor on the device."""
        if split not in self._dev_cache:
            _, images, _ = self.get_split(split)
            self._dev_cache[split] = torch.as_tensor(images, dtype=torch.float32,
                                                     device=self.device)
        return self._dev_cache[split]

    def iter_batches(self, split: str, batch_size: int, seed: int = 0
                     ) -> Iterator[tuple[Cameras, torch.Tensor, np.ndarray]]:
        """Infinite shuffled batches: (cameras [B], rgba [B, H, W, 4], idx)."""
        cams, _, _ = self.get_split(split)
        imgs = self.device_images(split)
        n = len(cams)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        pos = 0
        while True:
            if pos + batch_size > n:
                order = rng.permutation(n)
                pos = 0
            idx = order[pos: pos + batch_size]
            pos += batch_size
            didx = torch.as_tensor(idx, device=self.device)
            yield cams[didx], imgs[didx], idx
