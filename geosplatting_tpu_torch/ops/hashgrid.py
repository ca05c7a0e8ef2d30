"""Instant-NGP multiresolution hash encoding.

Counterpart of ``geosplatting_tpu/ops/hashgrid.py`` (``HashGridConfig``,
``hashgrid_encode``): per level a spatial hash of the cell corners (primes
1, 2654435761, 805459861, XOR, modulo the table size), level scalings
floor(min_res * growth^level), trilinear interpolation over the floor /
ceil corners of inputs in [-1, 1] mapped to [0, 1], and the grad-scaling
trick (input gradients scaled by 1/s, output gradients by s).

The hash is uint32 arithmetic that wraps modulo 2^32. PyTorch has no
general uint32 arithmetic on CUDA, so the products are taken in int64 (a
coordinate below 2^31 times a prime below 2^32 fits) and masked to their
low 32 bits before the XOR and the modulo, which gives the uint32 result.

It is a gather and a lerp, not a kernel: all 8 corners of every level are
one ``gather_rows`` of the table, whose backward is ``index_add_``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .segment_rows import gather_rows

_PRIMES = (1, 2654435761, 805459861)
_LOW32 = 0xFFFFFFFF
# corner (dx, dy, dz) of the trilinear cell, in the JAX package's order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    min_res: int = 16
    max_res: int = 1024
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    hash_init_scale: float = 0.001
    grad_scaling: float | None = None

    @property
    def table_size(self) -> int:
        return 2 ** self.log2_hashmap_size

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels <= 1:
            return 1.0
        return float(
            np.exp((np.log(self.max_res) - np.log(self.min_res)) / (self.num_levels - 1)))

    @property
    def scalings(self) -> np.ndarray:
        return np.floor(self.min_res * self.growth_factor ** np.arange(self.num_levels))

    def init(self, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
        """[L * table_size, features_per_level] uniform in +-hash_init_scale."""
        u = torch.rand((self.table_size * self.num_levels, self.features_per_level),
                       generator=generator, device=device)
        return (u * 2.0 - 1.0) * self.hash_init_scale


def hash_index(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """coords [..., 3] integer -> [...] table rows (the level's offset not
    included): (x * p0 ^ y * p1 ^ z * p2) mod 2^32 mod table_size."""
    c = coords.long()
    h = None
    for k, prime in enumerate(_PRIMES):
        term = (c[..., k] * prime) & _LOW32
        h = term if h is None else h ^ term
    return h % table_size


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    config: HashGridConfig) -> torch.Tensor:
    """x [..., 3] in [-1, 1] -> features [..., L * F]."""
    s = config.grad_scaling
    if s is not None:
        x = x / s + x.detach() * (1 - 1 / s)
    lead = x.shape[:-1]
    levels, fdim = config.num_levels, config.features_per_level
    scalings = torch.as_tensor(config.scalings, dtype=x.dtype, device=x.device)
    pos = x[..., None, :] * 0.5 + 0.5                           # [..., 1, 3]
    scaled = pos * scalings[:, None]                            # [..., L, 3]
    f = torch.floor(scaled)
    fi = f.long()
    ci = torch.ceil(scaled).long()
    lvl_off = torch.arange(levels, device=x.device) * config.table_size
    corners = []
    for dx, dy, dz in _CORNERS:
        coords = torch.stack((ci[..., 0] if dx else fi[..., 0],
                              ci[..., 1] if dy else fi[..., 1],
                              ci[..., 2] if dz else fi[..., 2]), -1)
        corners.append(hash_index(coords, config.table_size) + lvl_off)
    rows = gather_rows(table, torch.stack(corners, -2))          # [..., 8, L, F]
    c = rows.reshape(lead + (8, levels * fdim)).unbind(-2)
    offset = (scaled - f).repeat_interleave(fdim, dim=-2)       # [..., L*F, 3]
    ox, oy, oz = offset[..., 0], offset[..., 1], offset[..., 2]
    fx0 = c[0] * (1 - ox) + c[1] * ox
    fx1 = c[2] * (1 - ox) + c[3] * ox
    fx2 = c[4] * (1 - ox) + c[5] * ox
    fx3 = c[6] * (1 - ox) + c[7] * ox
    fy0 = fx0 * (1 - oy) + fx1 * oy
    fy1 = fx2 * (1 - oy) + fx3 * oy
    out = fy0 * (1 - oz) + fy1 * oz                             # [..., L*F]
    if s is not None:
        out = out * s + out.detach() * (1 - s)
    return out
