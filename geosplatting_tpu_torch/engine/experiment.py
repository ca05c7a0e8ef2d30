"""Experiment output management (counterpart of
``geosplatting_tpu/engine/experiment.py``): the ``outputs/<name>/<timestamp>/``
layout, timestamped text logging and image dumps under
``dump/{train,val,test}``."""
from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Experiment:
    name: str
    output_root: Path = Path("outputs")
    timestamp: str | None = None

    def __post_init__(self):
        if self.timestamp is None:
            self.timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
        self.output_root = Path(self.output_root)

    @property
    def base_dir(self) -> Path:
        return self.output_root / self.name / self.timestamp

    @property
    def ckpt_dir(self) -> Path:
        return self.base_dir / "ckpts"

    def setup(self) -> "Experiment":
        self.base_dir.mkdir(parents=True, exist_ok=True)
        return self

    @classmethod
    def attach(cls, base_dir: Path) -> "Experiment":
        """Re-attach to an existing ``outputs/<name>/<timestamp>`` directory
        (resume keeps logging into the original run directory)."""
        base_dir = Path(base_dir)
        return cls(
            name=base_dir.parent.name,
            output_root=base_dir.parent.parent,
            timestamp=base_dir.name,
        )

    def log(self, message: str) -> None:
        self.base_dir.mkdir(parents=True, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%H:%M:%S")
        with open(self.base_dir / "log.txt", "a") as f:
            f.write(f"[{stamp}] {message}\n")

    def dump_image(self, rel_path: str, image: np.ndarray) -> Path:
        from ..data.io import dump_float32_image

        path = self.base_dir / "dump" / rel_path
        dump_float32_image(path, np.asarray(image))
        return path
