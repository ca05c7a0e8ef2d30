"""COLMAP dataparser: a sparse reconstruction (``cameras.bin``,
``images.bin``, ``points3D.bin``) read into cameras, image paths and the
SfM points; and the DPKU capture layout on top of it.

Counterpart of ``geosplatting_tpu/data/dataparsers/colmap.py``
(``_read_cameras_bin``, ``_read_images_bin``, ``_read_points3d_bin``,
``_qvec2rot``, ``ColmapDataparser``, ``DPKUDataparser``), with its own copy
of the binary readers (the public COLMAP file format). The contract is the
JAX parser's: one focal (the first camera's ``fx``) and the image centre for
every view, the ``images_<downscale>`` folder where it exists, and every
``eval_interval``-th image (from the first) in the test split.
"""
from __future__ import annotations

import dataclasses
import shutil
import struct
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

from .blender_family import ParsedSplit

# parameters of each camera model id
_CAMERA_MODEL_PARAMS = {
    0: 3,   # SIMPLE_PINHOLE: f, cx, cy
    1: 4,   # PINHOLE: fx, fy, cx, cy
    2: 4,   # SIMPLE_RADIAL
    3: 5,   # RADIAL
    4: 8,   # OPENCV
}


def _read_cameras_bin(path: Path) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model, w, h = struct.unpack("<iiQQ", f.read(24))
            n_params = _CAMERA_MODEL_PARAMS.get(model, 4)
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cams[cam_id] = {"model": model, "width": w, "height": h, "params": params}
    return cams


def _read_images_bin(path: Path) -> list[dict]:
    images = []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            (image_id,) = struct.unpack("<I", f.read(4))
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            (cam_id,) = struct.unpack("<I", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (num_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * num_pts)   # the 2D points
            images.append({"id": image_id, "qvec": np.asarray(qvec), "tvec": np.asarray(tvec),
                           "camera_id": cam_id, "name": name.decode()})
    return images


def _read_points3d_bin(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(positions [P, 3] float32, colours [P, 3] float32 in [0, 1])."""
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            f.read(8)   # the point id
            xyz.append(struct.unpack("<3d", f.read(24)))
            rgb.append(struct.unpack("<3B", f.read(3)))
            f.read(8)   # the reprojection error
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.read(8 * track_len)
    return np.asarray(xyz, np.float32), np.asarray(rgb, np.float32) / 255.0


def _qvec2rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@dataclasses.dataclass(frozen=True)
class ColmapDataparser:
    """Layout: ``<path>/sparse/0/{cameras,images,points3D}.bin`` (or
    ``sparse/``, ``colmap/sparse/0``) and ``<path>/images/``."""

    downscale: int = 1
    eval_interval: int = 8   # every Nth image is a test view

    def _sparse_dir(self, path: Path) -> Path:
        for cand in (path / "sparse" / "0", path / "sparse", path / "colmap" / "sparse" / "0"):
            if (cand / "cameras.bin").exists():
                return cand
        raise FileNotFoundError(f"no COLMAP sparse model under {path}")

    def parse(self, path: Path, split: str) -> ParsedSplit:
        sparse = self._sparse_dir(path)
        cams = _read_cameras_bin(sparse / "cameras.bin")
        images = sorted(_read_images_bin(sparse / "images.bin"), key=lambda d: d["name"])
        img_dir = path / ("images" if self.downscale == 1 else f"images_{self.downscale}")
        if not img_dir.exists():
            img_dir = path / "images"
        c2ws, paths = [], []
        for im in images:
            r = _qvec2rot(im["qvec"])           # world to camera
            c2w = np.eye(4)
            c2w[:3, :3] = r.T
            c2w[:3, 3] = -r.T @ im["tvec"]
            c2w[:3, 1:3] *= -1   # COLMAP looks down +z with y down; here -z, y up
            c2ws.append(c2w[:3])
            paths.append(img_dir / im["name"])

        test = (np.arange(len(images)) % self.eval_interval) == 0
        pick = ~test if split in ("train", "val") else test
        cam0 = cams[images[0]["camera_id"]]
        fx = cam0["params"][0]
        scale = 1.0 / self.downscale
        pts_file = sparse / "points3D.bin"
        meta = None
        if pts_file.exists():
            xyz, rgb = _read_points3d_bin(pts_file)
            meta = {"points": xyz, "point_colors": rgb}
        return ParsedSplit(
            c2w=np.asarray(c2ws, np.float32)[pick],
            focal=fx * scale,
            width=int(cam0["width"] * scale), height=int(cam0["height"] * scale),
            near=0.01, far=1e3,
            image_paths=[p for p, m in zip(paths, pick) if m],
            meta=meta,
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        return any((path / sub / "cameras.bin").exists()
                   for sub in ("sparse/0", "sparse", "colmap/sparse/0"))


@dataclasses.dataclass(frozen=True)
class DPKUDataparser(ColmapDataparser):
    """DPKU capture layout: a COLMAP sparse model and ``database.db``. The
    views are read from the undistorted model in ``<path>/dense/``; where it
    is missing, the ``colmap`` binary's ``image_undistorter`` writes it when
    the binary is on PATH, and otherwise the distorted sparse model is read
    as it is, with a warning."""

    max_image_size: int = 1280

    def parse(self, path: Path, split: str) -> ParsedSplit:
        dense = path / "dense"
        if ColmapDataparser.recognize(dense):
            return super().parse(dense, split)
        if shutil.which("colmap") is not None:
            dense.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory() as td:
                subprocess.run(
                    ["colmap", "image_undistorter",
                     "--image_path", str(path / "images"),
                     "--input_path", str(path / "sparse" / "0"),
                     "--output_path", td,
                     "--max_image_size", str(self.max_image_size)],
                    check=True, capture_output=True,
                )
                (dense / "sparse").mkdir(exist_ok=True)
                (dense / "images").mkdir(exist_ok=True)
                shutil.move(str(Path(td) / "sparse"), str(dense / "sparse" / "0"))
                for pat in ("*.jpg", "*.JPG", "*.jpeg", "*.png", "*.PNG"):
                    for p in (Path(td) / "images").glob(f"**/{pat}"):
                        shutil.move(str(p), str(dense / "images" / p.name))
            return super().parse(dense, split)
        warnings.warn("DPKU: no dense model and no colmap binary; parsing the "
                      "distorted sparse model directly")
        return super().parse(path, split)

    @staticmethod
    def recognize(path: Path) -> bool:
        return all((path / p).exists() for p in (
            "sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin",
            "database.db"))
