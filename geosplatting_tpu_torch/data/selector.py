"""Camera selectors: ``SliceSelector`` picks an index range with a step;
``FanSelector`` picks the cameras whose azimuth lies in a wedge.

Counterpart of ``geosplatting_tpu/data/selector.py``: numpy in, numpy
index arrays out.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SliceSelector:
    start: int = 0
    stop: int | None = None
    step: int = 1

    def select(self, num_cameras: int, c2w: np.ndarray | None = None) -> np.ndarray:
        return np.arange(num_cameras)[self.start: self.stop: self.step]


@dataclasses.dataclass(frozen=True)
class FanSelector:
    """The cameras whose azimuth (about +z, from +x) lies within
    ``half_angle_degrees`` of ``center_degrees``."""

    center_degrees: float = 0.0
    half_angle_degrees: float = 45.0

    def select(self, num_cameras: int, c2w: np.ndarray) -> np.ndarray:
        pos = c2w[:, :3, 3]
        az = np.degrees(np.arctan2(pos[:, 1], pos[:, 0]))
        diff = (az - self.center_degrees + 180.0) % 360.0 - 180.0
        return np.nonzero(np.abs(diff) <= self.half_angle_degrees)[0]
