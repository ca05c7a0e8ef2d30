"""Point clouds (k nearest neighbours, farthest-point sampling, PLY IO),
rays and volume-rendering weights.

Counterpart of ``geosplatting_tpu/graphics/points.py`` (``Points``,
``Rays``, ``volume_rendering_weights``). The JAX package's ``lax.map`` over
chunks and ``lax.scan`` over samples are Python loops here. The PLY files
are the JAX writer's bytes (binary little endian: float x, y, z, then uchar
red, green, blue and float nx, ny, nz where present), written and read as
numpy structured arrays.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

_PLY_TYPES = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4",
              "float32": "<f4", "uint8": "u1"}


@dataclasses.dataclass
class Points:
    positions: torch.Tensor               # [N, 3]
    colors: torch.Tensor | None = None    # [N, 3] in [0, 1]
    normals: torch.Tensor | None = None   # [N, 3]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.positions.shape[:-1])

    def k_nearest(self, k: int, chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
        """(distances [N, k], indices [N, k]) of the k nearest other points,
        nearest first, from |a|^2 - 2 a.b + |b|^2 a chunk of rows at a time."""
        pts = self.positions
        p_sq = (pts * pts).sum(-1)
        dists, idxs = [], []
        for s in range(0, pts.shape[0], chunk):
            block = pts[s:s + chunk]
            d2 = (block * block).sum(-1)[:, None] - 2 * block @ pts.T + p_sq[None]
            neg, idx = torch.topk(-d2, k + 1, dim=-1)
            dists.append(torch.sqrt(torch.clamp(-neg[:, 1:], min=0.0)))
            idxs.append(idx[:, 1:])
        return torch.cat(dists), torch.cat(idxs)

    def farthest_point_sample(self, num_samples: int) -> torch.Tensor:
        """Indices [num_samples], from point 0, each the point farthest from
        those picked before it (the first on a tie)."""
        pts = self.positions
        dist = torch.full((pts.shape[0],), torch.inf, device=pts.device)
        picks = [torch.zeros((), dtype=torch.long, device=pts.device)]
        for _ in range(num_samples - 1):
            dist = torch.minimum(dist, ((pts - pts[picks[-1]]) ** 2).sum(-1))
            picks.append(torch.argmax(dist))
        return torch.stack(picks)

    # ---- PLY IO -------------------------------------------------------------
    def export_ply(self, path: Path | str) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fields = [(c, "<f4") for c in "xyz"]
        props = [f"property float {c}" for c in "xyz"]
        if self.colors is not None:
            fields += [(c, "u1") for c in ("red", "green", "blue")]
            props += [f"property uchar {c}" for c in ("red", "green", "blue")]
        if self.normals is not None:
            fields += [(f"n{c}", "<f4") for c in "xyz"]
            props += [f"property float n{c}" for c in "xyz"]
        n = self.positions.shape[0]
        rows = np.zeros(n, dtype=np.dtype(fields))
        pos = self.positions.detach().cpu().numpy().astype(np.float32)
        for i, c in enumerate("xyz"):
            rows[c] = pos[:, i]
        if self.colors is not None:
            col = (np.clip(self.colors.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            for i, c in enumerate(("red", "green", "blue")):
                rows[c] = col[:, i]
        if self.normals is not None:
            nrm = self.normals.detach().cpu().numpy().astype(np.float32)
            for i, c in enumerate("xyz"):
                rows[f"n{c}"] = nrm[:, i]
        header = ("ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(rows.tobytes())

    @classmethod
    def from_ply(cls, path: Path | str) -> "Points":
        """The vertex element of a PLY file, binary little endian or ascii:
        positions, colours (uchar / 255) and normals where present."""
        data = Path(path).read_bytes()
        header_end = data.index(b"end_header\n") + len(b"end_header\n")
        header = data[:header_end].decode()
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        for ln in header.strip().split("\n"):
            if ln.startswith("element"):
                in_vertex = ln.split()[1] == "vertex"
                if in_vertex:
                    n = int(ln.split()[-1])
            elif ln.startswith("property") and in_vertex:
                parts = ln.split()
                props.append((parts[1], parts[2]))
        names = [p[1] for p in props]
        if "binary_little_endian" in header:
            dt = np.dtype([(name, _PLY_TYPES[t]) for t, name in props])
            rows = np.frombuffer(data, dtype=dt, count=n, offset=header_end)
            arr = np.stack([rows[name].astype(np.float64) for name in names], -1)
        else:
            arr = np.asarray(data[header_end:].decode().split(), np.float64).reshape(n, len(props))

        def grab(keys, scale=1.0):
            if not all(k in names for k in keys):
                return None
            idx = [names.index(k) for k in keys]
            return torch.as_tensor((arr[:, idx] * scale).astype(np.float32))

        return cls(positions=grab(["x", "y", "z"]),
                   colors=grab(["red", "green", "blue"], 1 / 255.0),
                   normals=grab(["nx", "ny", "nz"]))


@dataclasses.dataclass
class Rays:
    origins: torch.Tensor      # [..., 3]
    directions: torch.Tensor   # [..., 3]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.origins.shape[:-1])

    def at(self, t: torch.Tensor) -> torch.Tensor:
        return self.origins + self.directions * t[..., None]

    def stratified_samples(self, num_samples: int, near: float, far: float, *,
                           generator: torch.Generator | None = None,
                           uniforms: torch.Tensor | None = None) -> torch.Tensor:
        """Stratified t values [..., S]: one uniform draw in each of S even
        bins of [near, far], from ``generator`` or given as ``uniforms``."""
        dev = self.origins.device
        bins = torch.linspace(near, far, num_samples + 1, device=dev)
        if uniforms is None:
            uniforms = torch.rand(self.shape + (num_samples,), generator=generator, device=dev)
        return bins[:-1] + uniforms * (bins[1:] - bins[:-1])


def volume_rendering_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Each sample's weight alpha x the transmittance before it, along the
    last axis."""
    alpha = 1.0 - torch.exp(-densities * deltas)
    log_1m = torch.log1p(-torch.clamp(alpha, max=0.9999))
    return alpha * torch.exp(torch.cumsum(log_1m, -1) - log_1m)
