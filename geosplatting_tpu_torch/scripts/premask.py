#!/usr/bin/env python
"""Premasker: mask a capture by an aligned mesh's silhouette (counterpart
of ``scripts/premask.py``).

Loads a reconstruction mesh, applies the rigid alignment (v - T) R^T S,
writes it beside the input as ``<mesh>_adjusted.ply``, rasterizes its
coverage (``ops/mesh_raster.py``) from every camera of every split the
dataset has (train, val, test, in that order), and writes the RF-masked
layout that ``RFMaskedRealDataparser`` reads: ``images/NNNN.png`` (the rgb
times the mask, and the mask as alpha) and ``cameras.pkl`` (``torch.save``
of c2w, fx, fy, cx, cy, width, height, near, far; the JAX script's keys and
dtypes).

    python -m geosplatting_tpu_torch.scripts.premask --mesh scans/object.ply \\
        --dataset_path data/cap --output data/cap_masked \\
        --translation -0.655 -0.317 0.647 \\
        --rotation 0.992 0.080 -0.097  0.080 0.192 0.978  0.097 -0.978 0.184 \\
        --scale 0.338 [--device cpu]

Where the JAX script drops the triangles past ``--tile_capacity`` in a tile
(or past the raster's pair budget) without a word, this one raises, naming
the fullest tile, so a mask never has holes.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.data.dataset import Dataset
from geosplatting_tpu_torch.data.io import dump_float32_image
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.graphics.mesh_io import load_mesh, save_mesh
from geosplatting_tpu_torch.ops.mesh_raster import rasterize_mesh


def align(vertices: np.ndarray, rotation, translation, scale: float) -> np.ndarray:
    """(v - T) R^T S, in float32 as the JAX script computes it."""
    r = np.asarray(rotation, np.float32).reshape(3, 3)
    t = np.asarray(translation, np.float32)
    return (vertices - t) @ r.T * scale


def coverage(mesh: TriangleMesh, cam: Cameras, tile_capacity: int) -> tuple[np.ndarray, dict]:
    """[H, W, 1] float32 silhouette of ``mesh`` from one camera, and the
    raster's fills; raises where the raster would drop a triangle."""
    rast, info = rasterize_mesh(mesh, cam, tile_capacity=tile_capacity)
    fills = {"max_tile_triangles": info.max_tile_triangles, "tile_fill": info.tile_fill,
             "pair_fill": info.pair_fill}
    if info.tile_fill > 1 or info.pair_fill > 1:
        raise ValueError(
            f"the mesh raster would drop triangles: {info.max_tile_triangles} in one tile "
            f"against --tile_capacity {tile_capacity}, {info.total_pairs} (triangle, tile) "
            f"pairs against a budget of {info.max_pairs}; raise --tile_capacity to at least "
            f"{info.max_tile_triangles}")
    return (rast.tri_id >= 0).float()[..., None].cpu().numpy(), fills


def all_splits(dataset: Dataset) -> tuple[Cameras, np.ndarray]:
    cams_all, imgs_all = [], []
    for split in ("train", "val", "test"):
        try:
            cams, imgs, _ = dataset.get_split(split)
        except (FileNotFoundError, ValueError):   # the layout has no such split
            continue
        cams_all.append(cams)
        imgs_all.append(np.asarray(imgs))
    return Cameras.cat(cams_all), np.concatenate(imgs_all)


def premask(mesh_path: Path, dataset_path: Path, output: Path, *,
            scale_factor: float | None = None, translation=(0, 0, 0),
            rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1), scale: float = 1.0,
            tile_capacity: int = 256, device=None, log=print) -> dict:
    """Write the masked layout under ``output``; returns the view count and
    the fullest tile over all views against the capacity."""
    device = _kernels.resolve_device(device)
    data = load_mesh(mesh_path)
    verts = align(data["vertices"], rotation, translation, scale)
    save_mesh(mesh_path.parent / f"{mesh_path.stem}_adjusted.ply", verts, data["indices"])
    mesh = TriangleMesh(vertices=torch.as_tensor(verts, device=device),
                        indices=torch.as_tensor(data["indices"], device=device).long())

    cams, imgs = all_splits(Dataset(dataset_path, scale_factor=scale_factor, device=device))
    out_images = Path(output) / "images"
    out_images.mkdir(parents=True, exist_ok=True)
    n = len(cams)
    fullest = 0
    for i in range(n):
        alpha, fills = coverage(mesh, cams[i], tile_capacity)
        fullest = max(fullest, fills["max_tile_triangles"])
        dump_float32_image(out_images / f"{i:04d}.png",
                           np.concatenate((imgs[i][..., :3] * alpha, alpha), -1))
        if (i + 1) % 20 == 0:
            log(f"masked {i + 1}/{n}")
    torch.save({
        "c2w": cams.c2w.cpu(), "fx": cams.fx.cpu(), "fy": cams.fy.cpu(),
        "cx": cams.cx.cpu(), "cy": cams.cy.cpu(),
        "width": torch.full((n,), cams.width, dtype=torch.long),
        "height": torch.full((n,), cams.height, dtype=torch.long),
        "near": torch.full((n,), float(cams.near)),
        "far": torch.full((n,), float(cams.far)),
    }, Path(output) / "cameras.pkl")
    log(f"wrote {n} masked images + cameras.pkl to {output}")
    return {"views": n, "max_tile_triangles": fullest, "tile_capacity": tile_capacity}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=Path, required=True)
    ap.add_argument("--dataset_path", type=Path, required=True)
    ap.add_argument("--output", type=Path, required=True)
    ap.add_argument("--scale_factor", type=float, default=None)
    ap.add_argument("--translation", type=float, nargs=3, default=(0, 0, 0))
    ap.add_argument("--rotation", type=float, nargs=9, default=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--tile_capacity", type=int, default=256)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    return premask(args.mesh, args.dataset_path, args.output, scale_factor=args.scale_factor,
                   translation=args.translation, rotation=args.rotation, scale=args.scale,
                   tile_capacity=args.tile_capacity, device=args.device)


if __name__ == "__main__":
    main()
