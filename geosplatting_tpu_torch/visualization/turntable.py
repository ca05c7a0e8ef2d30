"""Turntable camera schedule for the frames a training run writes.

Counterpart of ``geosplatting_tpu/visualization/turntable.py``: an orbit of
``spin_resolution`` cameras, an eased (x^k / k) spin position per training
step, and a frame wherever the integer frame index advances; the train loop
renders ``get_camera(step)`` into ``vis/<step>.png``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..graphics.cameras import Cameras


@dataclasses.dataclass
class OptimizationVisualizer:
    center: tuple = (0.0, 0.0, 0.0)
    up: str = "disable"           # '+y' | '+z' | 'disable'
    spin_resolution: int = 4096
    resolution: tuple = (800, 800)
    pitch_degree: float = 30.0
    radius: float = 3.2
    fov_degrees: float = 40.0

    num_ease_in_step: int = 300
    ease_exponent: float = 0.25
    frame_begin: int | None = None
    frame_end: int | None = None
    num_spins: float = 3.0
    num_frames_per_spin: int = 80
    device: str | None = None     # the orbit's cameras: the card unless "cpu"

    def setup(self, num_steps: int) -> None:
        """The step -> orbit-index schedule of a run of ``num_steps``."""
        self._sequence: dict[int, int] = {}
        if self.up == "disable":
            self._cameras = None
            return
        assert self.ease_exponent > 0
        self._cameras = Cameras.from_orbit(
            center=torch.tensor(self.center), radius=self.radius,
            elevation_degrees=self.pitch_degree, num_samples=self.spin_resolution,
            fov_degrees=self.fov_degrees, width=self.resolution[0], height=self.resolution[1],
            device=_kernels.resolve_device(self.device),
        )
        frame_end = num_steps if self.frame_end is None else self.frame_end
        offset = self.frame_begin or 0
        spin_per_step = self.num_spins / (
            self.num_ease_in_step * (1 / self.ease_exponent - 1) + frame_end
        )
        last_frame = -1
        for curr_step in range(1 + offset, num_steps + offset + 1):
            if curr_step <= self.num_ease_in_step:
                eased = (self.num_ease_in_step / self.ease_exponent
                         * ((curr_step - 1) / self.num_ease_in_step) ** self.ease_exponent)
            else:
                eased = (self.num_ease_in_step / self.ease_exponent
                         + (curr_step - self.num_ease_in_step))
            frame = spin_per_step * eased * self.num_frames_per_spin
            if int(frame) > last_frame:
                self._sequence[curr_step - offset] = round(
                    spin_per_step * eased * self.spin_resolution)
                last_frame = int(frame)

    def get_camera(self, curr_step: int) -> Cameras | None:
        """The camera of step ``curr_step`` (batch shape [1]), or None where
        the schedule writes no frame."""
        if self._cameras is None or curr_step not in self._sequence:
            return None
        i = self._sequence[curr_step] % self.spin_resolution
        return self._cameras[i:i + 1]
