"""Dataset orchestration: layout recognition, split caching and the shuffled
batch iterator of the train loop.

Counterpart of ``geosplatting_tpu/data/dataset.py``. A split's cameras live
on the dataset's device (the rendered layouts render their views there
too); its images are parsed once into one numpy stack
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
from .dataparsers.colmap import ColmapDataparser, DPKUDataparser
from .dataparsers.real_captures import (
    IDRDataparser, LLFFDataparser, MaskedIDRDataparser, MaskedLLFFDataparser,
    RFMaskedRealDataparser, StanfordORBDataparser,
)
from .dataparsers.synthetic_meshes import (
    MeshDRDataparser, MeshPBRDataparser, MeshViewSynthesisDataparser, ShapeNetDataparser,
)

# the JAX package's recognition order, most specific layout first
DATAPARSERS = (
    Syn4RelightDataparser,
    TensoIRDataparser,
    StanfordORBDataparser,
    BlenderDataparser,
    ShinyBlenderDataparser,
    MaskedIDRDataparser,
    IDRDataparser,
    MaskedLLFFDataparser,
    LLFFDataparser,
    RFMaskedRealDataparser,
    DPKUDataparser,
    ColmapDataparser,
    MeshPBRDataparser,
    MeshViewSynthesisDataparser,
    MeshDRDataparser,
    ShapeNetDataparser,
)


def recognize_dataparser(path: Path):
    """The parser of the first layout, in the JAX package's order, that
    ``path`` has; ``ValueError`` where none has it."""
    path = Path(path)
    for cls in DATAPARSERS:
        if cls.recognize(path):
            return cls()
    raise ValueError(f"no dataparser recognizes {path}")


def cameras_of(parsed: ParsedSplit, scale_factor: float | None, device) -> Cameras:
    """A parsed split's cameras: its per-camera intrinsics where it has them,
    else one focal and the image centre, scaled by ``scale_factor``
    (computed in numpy, stored float32, as the JAX package does)."""
    sf = scale_factor or 1.0
    n = parsed.c2w.shape[0]

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    def per_camera(value, default):
        return value if value is not None else np.full((n,), default)

    return Cameras(
        c2w=f32(parsed.c2w),
        fx=f32(per_camera(parsed.fx, parsed.focal) * sf),
        fy=f32(per_camera(parsed.fy, parsed.focal) * sf),
        cx=f32(per_camera(parsed.cx, parsed.width / 2.0) * sf),
        cy=f32(per_camera(parsed.cy, parsed.height / 2.0) * sf),
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
        # the rendered layouts draw their views on the dataset's device
        if getattr(self.dataparser, "device", False) is None:
            self.dataparser = dataclasses.replace(self.dataparser, device=self.device)
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
