"""The synthetic 2D layout: a flatland scene of random circles, seen from
cameras on an orbit and rendered by the analytic ``CircleShape2D``; no
files are read.

Counterpart of ``geosplatting_tpu/data/dataparsers/toy2d.py``
(``Synthetic2DDataparser``, ``MultiView2DDataset``). The circles and the
order of the views come from a CPU ``torch.Generator`` seeded with
``data_creation_seed`` (the JAX package splits a key of that seed, so the
scenes differ; its tests inject the JAX draws through ``_scene_draws``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import _kernels
from ...graphics.toy2d import Cameras2D, CircleShape2D


def _scene_draws(seed: int, num_circles: int, num_views: int
                 ) -> tuple[CircleShape2D, torch.Tensor]:
    """(the circles, a permutation of the views) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    shape = CircleShape2D.random(num_circles, generator=gen)
    return shape, torch.randperm(num_views, generator=gen)


@dataclasses.dataclass(frozen=True)
class Synthetic2DDataparser:
    """Splits of one orbit of views in a seeded random order: train the
    first, test the last, val those between."""

    num_circles: int = 3
    num_train_views: int = 8192
    num_val_views: int = 8192
    num_test_views: int = 200
    width: int = 800
    data_creation_seed: int = 123

    def parse2d(self, split: str, device=None
                ) -> tuple[Cameras2D, torch.Tensor, CircleShape2D]:
        """(cameras [N], rgba rows [N, W, 4], the scene) on ``device`` (the
        card unless another is named)."""
        device = _kernels.resolve_device(device)
        n = self.num_train_views + self.num_val_views + self.num_test_views
        shape, perm = _scene_draws(self.data_creation_seed, self.num_circles, n)
        shape = CircleShape2D(origins=shape.origins.to(device), radius=shape.radius.to(device))
        cams = Cameras2D.from_orbit(center=(0.0, 0.0), radius=1.0, num_samples=n,
                                    width=self.width, near=1e-3, far=2.0, hfov_degrees=60.0,
                                    device=device)[perm.to(device)]
        if split == "train":
            cams = cams[:self.num_train_views]
        elif split == "test":
            cams = cams[n - self.num_test_views:]
        elif split == "val":
            cams = cams[self.num_train_views:n - self.num_test_views]
        else:
            raise ValueError(split)
        return cams, shape.render(cams), shape


@dataclasses.dataclass
class MultiView2DDataset:
    """The 2D dataset: in-memory splits and the shuffled batch iterator
    (``np.random.default_rng(seed)`` orders, as the JAX package's)."""

    dataparser: Synthetic2DDataparser = dataclasses.field(default_factory=Synthetic2DDataparser)
    device: str | torch.device | None = None   # the card unless another is named

    def __post_init__(self):
        self.device = _kernels.resolve_device(self.device)
        self._cache: dict = {}

    def get_split(self, split: str):
        if split not in self._cache:
            self._cache[split] = self.dataparser.parse2d(split, self.device)
        return self._cache[split]

    def get_size(self, split: str) -> int:
        return len(self.get_split(split)[0])

    def iter_batches(self, split: str, batch_size: int, seed: int = 0):
        cams, images, _ = self.get_split(split)
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
            didx = torch.as_tensor(idx, device=images.device)
            yield cams[didx], images[didx], idx
