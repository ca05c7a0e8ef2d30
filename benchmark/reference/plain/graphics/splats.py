"""3D Gaussian splat container and the vanilla-3DGS densification.

Counterpart of ``geosplatting_tpu/graphics/splats.py`` (``Splats`` with
``random``, ``from_points``, ``cov3d_half``, ``cov3d``, ``reset_opacities``,
``_mean_knn_distance``, and ``split``,
``densify_and_cull``, ``cull`` and ``as_points``). ``scales`` are log-scales and
``opacities`` are logits. ``shs`` holds the SH coefficients past the DC
term, [N, K - 1, 3]; stages 1-3 leave it at its default [N, 0, 3].

Densify and cull return ``(new_splats, param_map)``: ``param_map[i]`` is the
old index of new slot ``i``, or -1 for a freshly created Gaussian, in the
JAX package's layout [kept..., split children..., duplicated...]; the
optimizer's state surgery (``train/optim.py``) reads it. Randomness is
explicit: the draws come from a ``torch.Generator`` or are injected as
tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import _kernels
from . import gmath

FIELDS = ("means", "scales", "quats", "colors", "opacities", "shs")


@dataclasses.dataclass
class Splats:
    means: torch.Tensor      # [N, 3]
    scales: torch.Tensor     # [N, 3] (log)
    quats: torch.Tensor      # [N, 4] (wxyz)
    colors: torch.Tensor     # [N, 3] (3DGS: the DC colour; stage 1: shading normals)
    opacities: torch.Tensor  # [N, 1] (logit)
    shs: torch.Tensor | None = None   # [N, K - 1, 3]; None -> [N, 0, 3]

    def __post_init__(self):
        if self.shs is None:
            self.shs = self.means.new_zeros((self.means.shape[0], 0, 3))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.means.shape[:-1])

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return gmath.sh_dim2deg(self.shs.shape[-2] + 1)

    def replace(self, **kw) -> "Splats":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, idx) -> "Splats":
        return Splats(**{k: getattr(self, k)[idx] for k in FIELDS})

    @classmethod
    def cat(cls, parts: list["Splats"]) -> "Splats":
        return cls(**{k: torch.cat([getattr(p, k) for p in parts]) for k in FIELDS})

    @classmethod
    def random(cls, size: int, *, sh_degree: int, random_scale: float,
               generator: torch.Generator | None = None, device=None,
               uniform: torch.Tensor | None = None,
               quat_normal: torch.Tensor | None = None) -> "Splats":
        """``size`` Gaussians uniform in the cube of half-width
        ``random_scale``, isotropic at their mean distance to the 3 nearest
        others, opacity 0.1, colour 0.5, random orientation; on the card
        unless ``device`` names another device. The uniform [size, 3] and
        the quaternions' normal [size, 4] draws come from ``generator`` or
        are injected."""
        device = _kernels.resolve_device(device)
        if uniform is None:
            uniform = torch.rand((size, 3), generator=generator, device=device)
        pts = (uniform.to(device) - 0.5) * (2 * random_scale)
        d = mean_knn_distance(pts, k=3)
        quats = gmath.random_quaternion(
            (size,), generator=generator, device=device,
            normal=None if quat_normal is None else quat_normal.to(device))
        return cls(
            means=pts,
            scales=torch.log(torch.clamp(d, min=1e-8))[:, None].repeat(1, 3),
            quats=quats,
            colors=torch.full((size, 3), 0.5, device=device),
            shs=torch.zeros((size, gmath.sh_deg2dim(sh_degree) - 1, 3), device=device),
            opacities=torch.full((size, 1), _logit(0.1), device=device),
        )

    @classmethod
    def from_points(cls, positions: torch.Tensor, colors: torch.Tensor, *, sh_degree: int,
                    generator: torch.Generator | None = None,
                    quat_normal: torch.Tensor | None = None) -> "Splats":
        """Gaussians at a point cloud's ``positions`` [N, 3] with its
        ``colors`` [N, 3]: isotropic at their mean distance to the 3 nearest
        others, opacity 0.1, random orientation, on the points' device. The
        quaternions' normal [N, 4] draws come from ``generator`` or are
        injected."""
        size, device = positions.shape[0], positions.device
        d = mean_knn_distance(positions, k=3)
        quats = gmath.random_quaternion(
            (size,), generator=generator, device=device,
            normal=None if quat_normal is None else quat_normal.to(device))
        return cls(
            means=positions,
            scales=torch.log(torch.clamp(d, min=1e-8))[:, None].repeat(1, 3),
            quats=quats,
            colors=colors,
            shs=torch.zeros((size, gmath.sh_deg2dim(sh_degree) - 1, 3), device=device),
            opacities=torch.full((size, 1), _logit(0.1), device=device),
        )

    def cov3d_half(self) -> torch.Tensor:
        """[N, 3, 3] rotation times the scales: M with cov3d = M M^T."""
        r = gmath.quat2rot(gmath.safe_normalize(self.quats))
        return r * torch.exp(self.scales)[..., None, :]

    def cov3d(self) -> torch.Tensor:
        m = self.cov3d_half()
        return m @ m.transpose(-1, -2)

    def reset_opacities(self, reset_value: float) -> "Splats":
        return self.replace(opacities=torch.clamp(self.opacities, max=_logit(reset_value)))


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


@torch.no_grad()
def mean_knn_distance(pts: torch.Tensor, k: int) -> torch.Tensor:
    """Mean distance of each point to its k nearest others. Brute force over
    row blocks against all points up to 2^19 candidates, beyond that against
    2^19 evenly spaced ones, as the JAX package does; a block's distance
    matrix stays under ~2 GB. Distances are taken from coordinate
    differences (no |a|^2 + |b|^2 - 2ab cancellation), as the JAX package
    takes them."""
    n = pts.shape[0]
    if n <= k:
        return torch.full((n,), 0.1, device=pts.device)
    cand = pts
    if n > (1 << 19):
        idx = torch.linspace(0, n - 1, 1 << 19, dtype=torch.float32, device=pts.device).long()
        cand = pts[idx]
    m = cand.shape[0]
    chunk = int(max(min(4096, (1 << 29) // max(m, 1)), 64))
    out = []
    for s in range(0, n, chunk):
        d = torch.cdist(pts[s:s + chunk], cand, compute_mode="donot_use_mm_for_euclid_dist")
        top = torch.topk(d, k + 1, dim=-1, largest=False).values   # includes self (0)
        out.append(top[:, 1:].mean(-1))
    return torch.cat(out)


# --- densification (between train steps) -----------------------------------------


def split(splats: Splats, num_splits: int, scale_factor: float = 1 / 1.6, *,
          generator: torch.Generator | None = None,
          randn: torch.Tensor | None = None) -> Splats:
    """``num_splits`` children sampled inside each Gaussian, scales shrunk by
    ``scale_factor``; the normal draws [num_splits, N, 3] come from
    ``generator`` or are injected as ``randn``."""
    n = splats.num_gaussians
    if randn is None:
        randn = torch.randn((num_splits, n, 3), generator=generator, device=splats.means.device)
    scaled = torch.exp(splats.scales)[None] * randn
    rots = gmath.quat2rot(gmath.safe_normalize(splats.quats))    # [N, 3, 3]
    offsets = torch.einsum("nij,snj->sni", rots, scaled)
    new_means = splats.means[None] + offsets

    def tile(x):
        return x[None].expand((num_splits,) + x.shape).reshape((num_splits * n,) + x.shape[1:])

    return Splats(
        means=new_means.reshape(-1, 3),
        scales=tile(splats.scales + math.log(scale_factor)),
        quats=tile(splats.quats), colors=tile(splats.colors), shs=tile(splats.shs),
        opacities=tile(splats.opacities),
    )


def _culls(splats: Splats, scale_max: torch.Tensor, cull_alpha_thresh: float,
           cull_scale_thresh: float | None) -> torch.Tensor:
    culls = torch.sigmoid(splats.opacities[:, 0]) < cull_alpha_thresh
    if cull_scale_thresh is not None:
        culls = culls | (scale_max > cull_scale_thresh)
    return culls


@torch.no_grad()
def densify_and_cull(
    splats: Splats,
    *,
    xys_grad_norm: torch.Tensor,   # [N] accumulated screen-space gradient norms
    vis_counts: torch.Tensor,      # [N] visibility counts
    last_wh: tuple[int, int],
    densify_grad_thresh: float,
    densify_size_thresh: float,
    num_splits: int,
    cull_alpha_thresh: float,
    cull_scale_thresh: float | None,
    generator: torch.Generator | None = None,
    randn: torch.Tensor | None = None,
) -> tuple[Splats, torch.Tensor]:
    """Split the large Gaussians with a high screen-space gradient,
    duplicate the small ones, drop the transparent (and too large) ones.
    Returns (new splats, param_map [N_new] int64 on the splats' device);
    ``randn`` [num_splits, N_split, 3] replaces the split's draws."""
    scale_max = torch.exp(splats.scales).max(-1).values
    vis = torch.clamp(vis_counts, min=1.0)
    avg_grad = 0.5 * max(last_wh) * (xys_grad_norm / vis)
    high_grads = avg_grad > densify_grad_thresh
    big = scale_max > densify_size_thresh
    dups = high_grads & ~big
    splits_mask = high_grads & big
    culls = _culls(splats, scale_max, cull_alpha_thresh, cull_scale_thresh)
    selected = ~(culls | splits_mask)

    sel_idx = torch.nonzero(selected)[:, 0]
    split_idx = torch.nonzero(splits_mask)[:, 0]
    dup_idx = torch.nonzero(dups)[:, 0]
    parts = [splats[sel_idx]]
    if len(split_idx):
        parts.append(split(splats[split_idx], num_splits, generator=generator, randn=randn))
    if len(dup_idx):
        parts.append(splats[dup_idx])
    new = Splats.cat(parts)
    param_map = torch.cat([sel_idx, sel_idx.new_full((new.num_gaussians - len(sel_idx),), -1)])
    return new, param_map


@torch.no_grad()
def cull(splats: Splats, *, cull_alpha_thresh: float,
         cull_scale_thresh: float | None) -> tuple[Splats, torch.Tensor]:
    scale_max = torch.exp(splats.scales).max(-1).values
    sel_idx = torch.nonzero(~_culls(splats, scale_max, cull_alpha_thresh, cull_scale_thresh))[:, 0]
    return splats[sel_idx], sel_idx


def as_points(splats: Splats, num_samples: int, *, generator: torch.Generator | None = None,
              idx: torch.Tensor | None = None, randn: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample points from the Gaussian mixture: ``num_samples`` Gaussians
    drawn in proportion to their volume exp(sum of log-scales) (``idx``),
    each offset by its scaled, rotated standard-normal draw (``randn``
    [num_samples, 3]); whichever draw is not given comes from
    ``generator``. Returns (positions [num_samples, 3], their colours)."""
    dev = splats.means.device
    if idx is None:
        volumes = torch.exp(splats.scales.sum(-1)) + 1e-20
        idx = torch.multinomial(volumes / volumes.sum(), num_samples, replacement=True,
                                generator=generator)
    if randn is None:
        randn = torch.randn((num_samples, 3), generator=generator, device=dev)
    offsets = randn * torch.exp(splats.scales[idx])
    rots = gmath.quat2rot(gmath.safe_normalize(splats.quats[idx]))
    pos = splats.means[idx] + torch.einsum("nij,nj->ni", rots, offsets)
    return pos, splats.colors[idx]
