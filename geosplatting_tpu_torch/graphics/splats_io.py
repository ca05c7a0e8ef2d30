"""Gaussian-splat PLY export and import in the standard 3DGS viewer layout.

Counterpart of ``geosplatting_tpu/graphics/splats_io.py``: binary
little-endian PLY with the properties x, y, z, nx, ny, nz (zeros),
f_dc_0..2, f_rest_* (where the splats carry SH), opacity (logit),
scale_0..2 (log) and rot_0..3 (normalised wxyz), all float32. The writer
is a numpy copy of the JAX one, so both write the same bytes for the same
Gaussians.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import _kernels
from .splats import Splats

SH_C0 = 0.28209479177387814


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def export_splats_ply(splats: Splats, path: Path | str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    means = _np(splats.means)
    n = means.shape[0]
    normals = np.zeros_like(means)
    f_dc = ((_np(splats.colors) - np.float32(0.5)) / np.float32(SH_C0)).astype(np.float32)
    sh_rest = _np(splats.shs).reshape(n, -1)              # [N, K * 3]
    quats = _np(splats.quats)
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)

    cols = [means, normals, f_dc]
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    if sh_rest.shape[1]:
        cols.append(sh_rest)
        names += [f"f_rest_{i}" for i in range(sh_rest.shape[1])]
    cols += [_np(splats.opacities), _np(splats.scales), quats]
    names += ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    data = np.concatenate(cols, axis=1).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {name}\n" for name in names)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def import_splats_ply(path: Path | str, device=None) -> Splats:
    """The splats of a file ``export_splats_ply`` (or the JAX package's
    writer) wrote, on the card unless ``device`` names another device."""
    device = _kernels.resolve_device(device)
    data = Path(path).read_bytes()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    n = 0
    names: list[str] = []
    for ln in data[:header_end].decode().split("\n"):
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        elif ln.startswith("property float"):
            names.append(ln.split()[-1])
    arr = np.frombuffer(data, dtype="<f4", count=n * len(names),
                        offset=header_end).reshape(n, len(names))
    col = {name: i for i, name in enumerate(names)}

    def grab(keys) -> np.ndarray:
        return arr[:, [col[k] for k in keys]]

    rest = sorted((k for k in names if k.startswith("f_rest_")),
                  key=lambda s: int(s.split("_")[-1]))
    shs = grab(rest).reshape(n, -1, 3) if rest else np.zeros((n, 0, 3), np.float32)
    fields = {
        "means": grab(["x", "y", "z"]),
        "scales": grab(["scale_0", "scale_1", "scale_2"]),
        "quats": grab(["rot_0", "rot_1", "rot_2", "rot_3"]),
        "colors": grab(["f_dc_0", "f_dc_1", "f_dc_2"]) * np.float32(SH_C0) + np.float32(0.5),
        "shs": shs,
        "opacities": grab(["opacity"]),
    }
    return Splats(**{k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
                     for k, v in fields.items()})
