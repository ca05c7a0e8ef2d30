"""Real-capture dataparsers: LLFF and masked LLFF, IDR / DTU and masked IDR,
Stanford-ORB, and the RF masked-real dump layout.

Counterpart of ``geosplatting_tpu/data/dataparsers/real_captures.py``
(``_modulo_split``, ``LLFFDataparser``, ``MaskedLLFFDataparser``,
``_decompose_projection``, ``_fit_sphere``, ``IDRDataparser``,
``MaskedIDRDataparser``, ``StanfordORBDataparser``,
``RFMaskedRealDataparser``), field for field:

- LLFF: ``poses_bounds.npy`` [N, 17], poses mapped (y, -x, z), centred on
  their mean and scaled by 1.1 over the largest (signed) coordinate,
  per-camera ``fx`` / ``fy`` from each pose's (height, width, focal), an
  8 / 1 / 1 modulo split (train, val, test);
- IDR: the projection matrices of ``cameras_large.npz`` decomposed by
  OpenCV into K and the pose, the columns flipped to the Blender camera,
  the cameras fitted to a sphere of radius sqrt(3) (3 for the masked
  layout) about the least-squares meeting point of their axes, and images
  and intrinsics at 0.4 of the stored size;
- Stanford-ORB: ``blender_LDR/<scene>`` transforms with ``*_mask`` folders,
  a 2/3 translation scale, the 2048-pixel views at half size, and the
  ground-truth mesh's path in ``meta``;
- RF masked-real: ``images/`` and ``cameras.pkl`` (tensors saved by
  ``torch.save``) with a 7 / 1 / 2 modulo split. The file is read with
  ``weights_only=True``: it holds tensors only, and no pickled code runs.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..io import load_float32_image
from .blender_family import ParsedSplit


def _modulo_split(n: int, split: str, ratios: tuple[int, int, int]) -> list:
    """Indices of ``split`` by index modulo sum(ratios): the train block
    first, then test, then val (ratios are train, val, test)."""
    tr, va, te = ratios
    s = tr + va + te
    ranges = {"train": (0, tr), "test": (tr, tr + te), "val": (tr + te, s)}
    if split not in ranges:
        raise ValueError(f"unknown split: {split}")
    lo, hi = ranges[split]
    return [i for i in range(n) if lo <= (i % s) < hi]


@dataclasses.dataclass(frozen=True)
class LLFFDataparser:
    """Forward-facing captures: ``images/*.JPG`` (or ``*.jpg``) and
    ``poses_bounds.npy``."""

    train_split_ratio: int = 8
    val_split_ratio: int = 1
    test_split_ratio: int = 1
    masked: bool = False

    def parse(self, path: Path, split: str) -> ParsedSplit:
        pb = np.load(path / "poses_bounds.npy").astype(np.float32)   # [N, 17]
        poses = pb[:, :15].reshape(-1, 3, 5)
        hwf = poses[:, :, 4]                                        # height, width, focal
        c2w = poses[:, :, :4].copy()
        c2w[:, :, 0] = poses[:, :, 1]
        c2w[:, :, 1] = -poses[:, :, 0]
        bounds = pb[:, 15:]
        files = sorted((path / "images").glob("*.JPG"), key=lambda p: p.name)
        if not files:
            files = sorted((path / "images").glob("*.jpg"), key=lambda p: p.name)
        h, w = load_float32_image(files[0]).shape[:2]
        c2w[:, :, 3] -= c2w[:, :, 3].mean(0)
        # the signed largest coordinate, not the absolute one (the JAX
        # parser's contract): an asymmetric capture can leave the box
        rescale = 1.1 / c2w[:, :, 3].max()
        c2w[:, :, 3] *= rescale
        idx = _modulo_split(poses.shape[0], split, (
            self.train_split_ratio, self.val_split_ratio, self.test_split_ratio))
        mask_paths = None
        if self.masked:
            masks = {p.stem: p for p in (path / "masks").iterdir()}
            mask_paths = [masks[files[i].stem] for i in idx]
        return ParsedSplit(
            c2w=c2w[idx],
            focal=float(hwf[0, 2]),
            fx=(hwf[:, 2] / hwf[:, 1] * w)[idx],
            fy=(hwf[:, 2] / hwf[:, 0] * h)[idx],
            cx=np.full(len(idx), w / 2.0, np.float32),
            cy=np.full(len(idx), h / 2.0, np.float32),
            width=w, height=h,
            near=float(bounds[idx, 0].min() * rescale),
            far=float(bounds[idx, 1].max() * rescale),
            image_paths=[files[i] for i in idx],
            mask_paths=mask_paths,
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        return (path / "images").exists() and (path / "poses_bounds.npy").exists()


@dataclasses.dataclass(frozen=True)
class MaskedLLFFDataparser(LLFFDataparser):
    """LLFF with ``masks/<image stem>.*`` as the alpha."""

    masked: bool = True

    @staticmethod
    def recognize(path: Path) -> bool:
        return ((path / "images").exists() and (path / "masks").exists()
                and (path / "poses_bounds.npy").exists())


def _decompose_projection(P: np.ndarray):
    """(K [3, 3], c2w [3, 4]) of a 3x4 projection, by OpenCV."""
    import cv2

    K, R, t = cv2.decomposeProjectionMatrix(P.astype(np.float64))[:3]
    K = K / K[2, 2]
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = (t[:3] / t[3])[:, 0]
    return K.astype(np.float32), c2w[:3, :4].astype(np.float32)


def _fit_sphere(c2w: np.ndarray, radius: float) -> np.ndarray:
    """The cameras centred on the least-squares meeting point of their
    viewing axes, each moved along its direction from there to ``radius``."""
    c2w = c2w.copy()
    pos = c2w[:, :, 3]
    d = -c2w[:, :, 2]
    a_n = np.eye(3, dtype=np.float64)[None] - d[:, :, None] @ d[:, None, :]   # [N, 3, 3]
    b = (a_n @ pos[:, :, None]).sum(0)
    center = np.linalg.lstsq(a_n.sum(0), b, rcond=None)[0][:, 0]
    pos = pos - center
    norm = np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-8)
    c2w[:, :, 3] = (pos / norm * radius).astype(c2w.dtype)
    return c2w


@dataclasses.dataclass(frozen=True)
class IDRDataparser:
    """DTU / IDR layout: ``image/*.png`` and ``cameras_large.npz``."""

    scale_factor: float = 0.4
    masked: bool = False
    fit_radius: float = 3.0 ** 0.5

    def parse(self, path: Path, split: str) -> ParsedSplit:
        files = sorted((path / "image").glob("*.png"), key=lambda p: p.name)
        n = len(files)
        h, w = load_float32_image(files[0]).shape[:2]
        cam = np.load(path / "cameras_large.npz")
        c2w = np.zeros((n, 3, 4), np.float32)
        fx, fy, cx, cy = (np.zeros(n, np.float32) for _ in range(4))
        for i in range(n):
            P = cam[f"world_mat_{i}"] @ cam[f"scale_mat_{i}"]
            K, pose = _decompose_projection(P[:3, :4])
            c2w[i] = pose
            fx[i], fy[i], cx[i], cy[i] = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        c2w[:, :, 1:3] *= -1   # the COLMAP camera to the Blender one
        c2w = _fit_sphere(c2w, radius=self.fit_radius)
        sf = self.scale_factor
        mask_paths = [path / "mask" / f"{i:03d}.png" for i in range(n)] if self.masked else None
        return ParsedSplit(
            c2w=c2w,
            focal=float(fx[0] * sf),
            fx=fx * sf, fy=fy * sf, cx=cx * sf, cy=cy * sf,
            width=int(w * sf), height=int(h * sf),
            near=1e-2, far=1e2,
            image_paths=files,
            mask_paths=mask_paths,
            image_scale=sf,
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        return (path / "image" / "000000.png").exists() and (path / "cameras_large.npz").exists()


@dataclasses.dataclass(frozen=True)
class MaskedIDRDataparser(IDRDataparser):
    """IDR with ``mask/<index:03d>.png`` and a fit radius of 3."""

    masked: bool = True
    fit_radius: float = 3.0

    @staticmethod
    def recognize(path: Path) -> bool:
        return ((path / "image" / "000000.png").exists()
                and (path / "mask" / "000.png").exists()
                and (path / "cameras_large.npz").exists())


@dataclasses.dataclass(frozen=True)
class StanfordORBDataparser:
    """Stanford-ORB ``blender_LDR/<scene>``: 2048 x 2048 views read at
    ``scale_factor``; the val split is the train split."""

    scale_factor: float = 0.5

    def parse(self, path: Path, split: str) -> ParsedSplit:
        if split == "val":
            split = "train"
        with open(path / f"transforms_{split}.json") as f:
            meta = json.load(f)
        frames = meta["frames"]
        wh = int(2048 * self.scale_factor)
        c2w = np.array([f_["transform_matrix"] for f_ in frames], np.float32)[:, :3, :]
        c2w[:, :, 3] *= 2 / 3
        focal = 0.5 * wh / np.tan(0.5 * float(meta["camera_angle_x"]))
        gt_mesh = path.parent.parent / "ground_truth" / path.name / "mesh_blender" / "mesh.obj"
        return ParsedSplit(
            c2w=c2w, focal=focal, width=wh, height=wh, near=4 / 3, far=4.0,
            image_paths=[path / (f_["file_path"] + ".png") for f_ in frames],
            mask_paths=[path / (f_["file_path"].replace(split, split + "_mask") + ".png")
                        for f_ in frames],
            image_scale=self.scale_factor,
            meta={"gt_mesh": gt_mesh, "mesh_scale": 2 / 3},
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        needed = ("train", "train_mask", "test", "test_mask", "transforms_train.json",
                  "transforms_test.json", "transforms_novel.json")
        return (all((path / p).exists() for p in needed) and path.parent.name == "blender_LDR"
                and (path.parent.parent / "ground_truth" / path.name).exists())


@dataclasses.dataclass(frozen=True)
class RFMaskedRealDataparser:
    """``images/<index:04d>.png`` and ``cameras.pkl``: a dict of tensors
    ``c2w`` [N, 3, 4], ``fx``, ``fy``, ``cx``, ``cy``, ``width``,
    ``height``, ``near``, ``far`` [N]."""

    train_split_ratio: int = 7
    val_split_ratio: int = 1
    test_split_ratio: int = 2

    def parse(self, path: Path, split: str) -> ParsedSplit:
        import torch

        cam = torch.load(path / "cameras.pkl", map_location="cpu", weights_only=True)
        idx = _modulo_split(cam["c2w"].shape[0], split, (
            self.train_split_ratio, self.val_split_ratio, self.test_split_ratio))
        a = {k: np.asarray(v) for k, v in cam.items()}
        return ParsedSplit(
            c2w=a["c2w"][idx].astype(np.float32),
            focal=float(a["fx"][idx][0]),
            fx=a["fx"][idx].astype(np.float32), fy=a["fy"][idx].astype(np.float32),
            cx=a["cx"][idx].astype(np.float32), cy=a["cy"][idx].astype(np.float32),
            width=int(a["width"][0]), height=int(a["height"][0]),
            near=float(a["near"].min()), far=float(a["far"].max()),
            image_paths=[path / "images" / f"{i:04d}.png" for i in idx],
        )

    @staticmethod
    def recognize(path: Path) -> bool:
        return (path / "images" / "0000.png").exists() and (path / "cameras.pkl").exists()
