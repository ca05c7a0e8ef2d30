"""GeoSplatter stage 1 — FlexiCubes -> MGAdapter Gaussians -> split-sum PBR.

Counterpart of ``geosplatting_tpu/models/geosplat.py`` on the stage-1
training path: ``tone_naive``, ``MGAdapter``, the ``SharedField`` material
field (one triplane trunk + MLP heads), ``compact_faces``, face and vertex
Gaussian sampling, split-sum shading and ``GeoSplatter`` (an ``nn.Module``
that owns the stage-1 parameters) with ``get_geometry``, ``get_envmap`` and
the per-camera ``render``.

Randomness is explicit: ``render`` takes the jitter noise as a tensor (a
standard-normal draw, the JAX package's ``geosplat.py:498``) or draws it
from the caller's ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.profiler import record_function

from .. import _kernels
from ..graphics import flexicubes as fc
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.mesh import TriangleMesh
from ..graphics.splats import Splats
from ..ops import cubemap as cm
from ..ops.rasterize import rasterize
from ..ops.segment_rows import gather_rows
from .encodings import TriplaneEncoding
from .mlp import MLP

_UP = (0.0, 0.0, 1.0)


def tone_naive(rgb: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    x = rgb * exposure
    return 1.0 - nn.functional.softplus((1.0 - x) * 100.0) / 100.0


# --- MGAdapter ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MGAdapter:
    scale_ratio1: float = 0.5
    scale_ratio2: float = 1.3
    g_scale_ratio: float = 1.6
    l_scale_ratio1: float = 1 / 3
    l_scale_ratio2: float = 3.0
    bias1: float = -1 / 24
    bias2: float = 0.0

    def bary2gs(self, p0, p1, area, normals, *, max_scale_ratio):
        """Segment (p0, p1) + patch area + face normal -> flat anisotropic
        Gaussian (means, log-scales, quats)."""
        means = (p0 + p1) / 2
        max_rots = p1 - means
        max_scales = torch.clamp(
            torch.sqrt((max_rots ** 2).sum(-1, keepdim=True) + 1e-24), min=1e-10
        )
        min_scales = area / 4 / max_scales
        max_rots = max_rots / max_scales
        scales = torch.cat(
            (
                torch.log(self.g_scale_ratio * max_scale_ratio * max_scales),
                torch.log(torch.clamp(self.g_scale_ratio / max_scale_ratio * min_scales, min=1e-12)),
                torch.full_like(max_scales, -10.0),
            ),
            -1,
        )
        min_rots = torch.cross(normals, max_rots, dim=-1)
        rot = torch.stack((max_rots, min_rots, normals), -1)  # columns
        return means, scales, gmath.rot2quat(rot)

    def make(self, mesh: TriangleMesh) -> tuple[Splats, torch.Tensor, torch.Tensor]:
        """Mesh -> 6 Gaussians per face: (splats [6F], offsets [6F, 3],
        valid [6F]); masked faces give opacity ~0 Gaussians."""
        vn = mesh.vertex_normals()
        idx = mesh.indices
        p0, p1, p2 = gather_rows(mesh.vertices, idx).unbind(1)
        vn0, vn1, vn2 = gather_rows(vn, idx).unbind(1)
        fmask = mesh.face_mask_or_ones()

        cross = torch.cross(p1 - p0, p2 - p0, dim=-1)
        area = torch.clamp(torch.sqrt((cross ** 2).sum(-1, keepdim=True) + 1e-24), min=1e-10) / 2
        up = cross.new_tensor(_UP)
        normals = gmath.safe_normalize(torch.where(fmask[:, None], cross, up))
        offsets = normals.detach() * torch.sqrt(area.detach())

        all_means, all_scales, all_quats, all_normals = [], [], [], []
        for u_coeff, a_coeff, s_ratio in zip(
            (1 / 9 + self.bias1, 2 / 9 + self.bias2),
            (1 / 4 * self.l_scale_ratio1, 1 / 12 * self.l_scale_ratio2),
            (self.scale_ratio1, self.scale_ratio2),
        ):
            u0 = p0 * (1 - 2 * u_coeff) + (p1 + p2) * u_coeff
            u1 = p1 * (1 - 2 * u_coeff) + (p2 + p0) * u_coeff
            u2 = p2 * (1 - 2 * u_coeff) + (p0 + p1) * u_coeff
            n0 = vn0 * (1 - 2 * u_coeff) + (vn1 + vn2) * u_coeff
            n1 = vn1 * (1 - 2 * u_coeff) + (vn2 + vn0) * u_coeff
            n2 = vn2 * (1 - 2 * u_coeff) + (vn0 + vn1) * u_coeff
            a = area * a_coeff
            for (qa, qb), nn_ in (((u0, u1), (n0 + n1) / 2),
                                  ((u1, u2), (n1 + n2) / 2),
                                  ((u2, u0), (n2 + n0) / 2)):
                m, s, q = self.bary2gs(qa, qb, a, normals, max_scale_ratio=s_ratio)
                all_means.append(m)
                all_scales.append(s)
                all_quats.append(q)
                all_normals.append(gmath.safe_normalize(nn_))

        valid = fmask.repeat(6)
        op = torch.where(valid, math.log(0.99 / 0.01), -20.0)[:, None]
        splats = Splats(
            means=torch.cat(all_means),
            scales=torch.cat(all_scales),
            quats=torch.cat(all_quats),
            colors=torch.cat(all_normals),  # shading normals
            opacities=op,
        )
        return splats, offsets.repeat(6, 1), valid


# --- material field ---------------------------------------------------------------


class SharedField(nn.Module):
    """One triplane trunk + small MLP heads (kd: sigmoid RGB, ks: raw
    roughness/metallic, z: raw normal offset), evaluated per face."""

    def __init__(self, *, resolution: int = 512, num_components: int = 32,
                 init_scale: float = 0.03, hidden: int = 64,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.trunk = TriplaneEncoding(resolution, num_components, init_scale, **kw)
        self.kd = MLP((num_components, hidden, 3), activation="sigmoid", **kw)
        self.ks = MLP((num_components, hidden, 2), **kw)
        self.z = MLP((num_components, hidden, 1), **kw)

    def apply_all(self, x: torch.Tensor, x_jitter: torch.Tensor | None = None) -> dict:
        """Every head at positions ``x`` [P, 3] in [-1, 1]. The z head sees a
        position-detached trunk evaluation."""
        feats = self.trunk(x)
        out = {
            "kd": self.kd(feats),
            "ks_raw": self.ks(feats),
            "z_raw": self.z(self.trunk(x.detach())),
        }
        if x_jitter is not None:
            feats_j = self.trunk(x_jitter)
            out["kd_jitter"] = self.kd(feats_j)
            out["ks_jitter_raw"] = self.ks(feats_j)
        return out


@dataclasses.dataclass
class RenderableAttrs:
    """Per-Gaussian shading inputs."""

    kd: torch.Tensor                          # [N, 3]
    ks: torch.Tensor                          # [N, 2] (roughness, metallic) pre-remap
    normals: torch.Tensor                     # [N, 3]
    kd_jitter: torch.Tensor | None = None
    ks_jitter: torch.Tensor | None = None


def compact_faces(mesh: TriangleMesh, max_faces: int) -> TriangleMesh:
    """Gather valid faces into a static budget of ``max_faces`` (ascending
    order; overflow drops the faces past the cap)."""
    f = mesh.num_faces
    if max_faces >= f:
        return mesh
    idx = fc.nonzero_padded(mesh.face_mask_or_ones(), max_faces, f)
    indices = torch.cat([mesh.indices, mesh.indices.new_zeros((1, 3))])[idx]
    return TriangleMesh(vertices=mesh.vertices, indices=indices, face_mask=idx < f)


def field_points(mesh: TriangleMesh, scale: float) -> torch.Tensor:
    """Per-face field evaluation points: face centroids / scale in [-1, 1]."""
    return torch.clamp(mesh.face_vertices().mean(1) / scale, -1, 1)


def get_gaussians_from_face(
    field: SharedField,
    mesh: TriangleMesh,
    *,
    scale: float,
    initial_guess: torch.Tensor,       # [2]
    kd_perturb_std: float = 0.0,
    ks_perturb_std: float = 0.0,
    jitter_noise: torch.Tensor | None = None,   # [F, 3] standard normal
    max_faces: int | None = None,
) -> tuple[Splats, RenderableAttrs, torch.Tensor, torch.Tensor]:
    """(splats, attrs, offsets, valid) with the field evaluated per face and
    shared by the face's 6 Gaussians. One jitter position (std =
    kd_perturb_std, else ks_perturb_std) serves both smoothness terms."""
    if max_faces is not None:
        mesh = compact_faces(mesh, max_faces)
    splats, offsets, valid = MGAdapter().make(mesh)
    pts = field_points(mesh, scale)

    def expand(v):
        return v.repeat(6, 1)

    x_jitter = None
    jit_std = kd_perturb_std if kd_perturb_std > 0 else ks_perturb_std
    if jit_std > 0 and jitter_noise is not None:
        x_jitter = torch.clamp(pts + jitter_noise * jit_std, -1, 1)

    res = field.apply_all(pts, x_jitter)
    offsets = offsets * torch.sigmoid(expand(res["z_raw"]))
    attrs = RenderableAttrs(
        kd=expand(res["kd"]),
        ks=torch.sigmoid(expand(res["ks_raw"]) + initial_guess),
        normals=splats.colors,
        kd_jitter=expand(res["kd_jitter"]) if "kd_jitter" in res and kd_perturb_std > 0 else None,
        ks_jitter=(
            torch.sigmoid(expand(res["ks_jitter_raw"]) + initial_guess)
            if "ks_jitter_raw" in res and ks_perturb_std > 0 else None
        ),
    )
    return splats.replace(means=splats.means - offsets), attrs, offsets, valid


def get_gaussians_from_vertex(
    field: SharedField,
    mesh: TriangleMesh,
    *,
    scale: float,
    initial_guess: torch.Tensor,
) -> tuple[Splats, RenderableAttrs, torch.Tensor]:
    """Vertex-area Gaussians for the warm-up phase: (splats, attrs, valid)."""
    vn = mesh.vertex_normals()
    idx = mesh.indices
    fmask = mesh.face_mask_or_ones()
    fv = mesh.face_vertices()
    weighted_fn = torch.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    weighted_fn = torch.where(fmask[:, None], weighted_fn, 0.0)
    # vertex area = sum over faces of (face normal . vertex normal) / 6
    products = (weighted_fn[:, None, :] * gather_rows(vn, idx)).sum(-1)  # [F, 3]
    vertex_areas = vn.new_zeros(mesh.num_vertices)
    for k in range(3):
        vertex_areas = vertex_areas.index_add(
            0, idx[:, k], torch.where(fmask, products[:, k], 0.0)
        )
    valid = vertex_areas > 1e-10
    areas = torch.clamp(vertex_areas, min=1e-10)[:, None] / 6.0
    up = vn.new_tensor(_UP)
    vn = torch.where(valid[:, None], vn, up)

    log_sqrt_areas = torch.log(areas / 2.5) * 0.5
    heads = field.apply_all(torch.clamp(mesh.vertices / scale, -1, 1))
    z_off = torch.exp(log_sqrt_areas.detach()) * torch.sigmoid(heads["z_raw"])
    positions = mesh.vertices - vn * z_off
    base_rot = gmath.rotation_from_relative_vectors(up.expand(vn.shape), vn.detach())
    scales = torch.cat(
        (log_sqrt_areas, log_sqrt_areas, torch.full_like(log_sqrt_areas, -23.0)), -1
    )
    attrs = RenderableAttrs(
        kd=heads["kd"],
        ks=torch.sigmoid(heads["ks_raw"] + initial_guess),
        normals=vn,
    )
    op = torch.where(valid, math.log(0.99 / 0.01), -20.0)[:, None]
    splats = Splats(
        means=positions, scales=scales, quats=gmath.rot2quat(base_rot),
        colors=vn, opacities=op,
    )
    return splats, attrs, valid


# --- split-sum shading -----------------------------------------------------------


def shade_colors_splitsum(
    splats: Splats,
    attrs: RenderableAttrs,
    camera_pos: torch.Tensor,           # [3]
    *,
    env_base: torch.Tensor,
    env_mips: list[torch.Tensor],
    min_roughness: float,
    max_metallic: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-Gaussian split-sum GGX radiance with the analytic FG term and the
    nearest environment lookup. Returns (colors [N, 3], opacities [N])."""
    wo = gmath.safe_normalize(camera_pos - splats.means)
    opacities = torch.sigmoid(splats.opacities[:, 0])
    roughness = attrs.ks[:, 0:1] * (1 - min_roughness) + min_roughness
    metallic = attrs.ks[:, 1:2] * max_metallic
    specular = (1.0 - metallic) * 0.04 + attrs.kd * metallic
    diffuse = attrs.kd * (1.0 - metallic)
    n_dot_v = torch.clamp((attrs.normals * wo).sum(-1, keepdim=True), min=1e-6)
    fg = cm.fg_analytic(n_dot_v, roughness)
    inv_wi = 2.0 * (wo * attrs.normals).sum(-1, keepdim=True) * attrs.normals - wo
    _, l_spec = cm.sample_splitsum(
        env_base, env_mips, attrs.normals, inv_wi, roughness, with_diffuse=False
    )
    reflectance = specular * fg[:, 0:1] + fg[:, 1:2]
    return diffuse + l_spec * reflectance, opacities


def shade_splitsum(
    splats: Splats,
    attrs: RenderableAttrs,
    camera: Cameras,                    # one camera
    *,
    exposure: torch.Tensor,
    env_base: torch.Tensor,
    env_mips: list[torch.Tensor],
    min_roughness: float,
    max_metallic: float,
    pairs_per_gaussian: int = 6,
    pairs_budget: int | None = None,
    tile_shape: str = "16",
) -> tuple[torch.Tensor, dict]:
    """Split-sum shading, antialiased rasterization and naive tone mapping
    for one camera. Returns ([H, W, 4] rgba, {total_pairs, max_pairs})."""
    colors, opacities = shade_colors_splitsum(
        splats, attrs, camera.camera_pos, env_base=env_base, env_mips=env_mips,
        min_roughness=min_roughness, max_metallic=max_metallic,
    )
    render, alpha, info = rasterize(
        splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
        opacities, colors, camera.view_matrix, camera.intrinsic_matrix,
        camera.width, camera.height,
        rasterize_mode="antialiased", pairs_per_gaussian=pairs_per_gaussian,
        max_pairs_override=pairs_budget, tile_size=tile_shape,
    )
    rgb = tone_naive(render[..., :3], exposure)
    pair_info = {"total_pairs": info["total_pairs"], "max_pairs": info["max_pairs"]}
    return torch.cat((rgb, alpha), -1), pair_info


# --- GeoSplatter ------------------------------------------------------------------

_INITIAL_GUESS = {
    "outdoor": (0.0, 0.0),
    "diffuse": (0.0, -3.0),
    "hybrid": (-3.0, -3.0),
    "specular": (-3.0, 0.0),
    "glossy": (-3.0, 0.0),
}


class GeoSplatter(nn.Module):
    """Stage-1 model. Parameters: ``sdf`` [V], ``deform`` [V, 3], ``weights``
    [cubes, 21], ``cubemap`` [6, R, R, 3], ``exposure`` [1] and the
    ``field`` module. Runs on CUDA unless ``device`` says otherwise."""

    def __init__(
        self,
        *,
        resolution: int = 32,
        light_resolution: int = 512,
        scale: float = 1.05,
        min_roughness: float = 0.1,
        max_metallic: float = 1.0,
        initial_guess: str = "hybrid",
        smooth_type: str = "jitter",
        surf_cube_budget: float = 8.0,
        surf_edge_budget: float = 8.0,
        max_render_faces: int = 1 << 18,
        pairs_per_gaussian: int = 3,
        pairs_budget: int | None = None,
        tile_shape: str = "16",
        triplane_resolution: int = 512,
        triplane_components: int = 32,
        field_hidden: int = 64,
        generator: torch.Generator | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        device = _kernels.resolve_device(device)
        self.resolution = resolution
        self.light_resolution = light_resolution
        self.scale = scale
        self.min_roughness = min_roughness
        self.max_metallic = max_metallic
        self.initial_guess = initial_guess
        self.smooth_type = smooth_type
        self.max_render_faces = max_render_faces
        self.pairs_per_gaussian = pairs_per_gaussian
        self.pairs_budget = pairs_budget
        self.tile_shape = tile_shape
        self.grid = fc.make_grid(
            resolution, scale=scale, surf_cube_budget=surf_cube_budget,
            surf_edge_budget=surf_edge_budget,
        )
        g = self.grid
        sdf = torch.rand(g.num_vertices, generator=generator, device=device) - 0.1
        self.sdf = nn.Parameter(sdf)
        self.deform = nn.Parameter(torch.zeros((g.num_vertices, 3), device=device))
        self.weights = nn.Parameter(torch.zeros((g.num_cubes, 21), device=device))
        self.cubemap = nn.Parameter(
            torch.full((6, light_resolution, light_resolution, 3), 0.5, device=device)
        )
        self.exposure = nn.Parameter(torch.zeros(1, device=device))
        self.field = SharedField(
            resolution=triplane_resolution, num_components=triplane_components,
            hidden=field_hidden, generator=generator, device=device,
        )
        self.register_buffer(
            "initial_guess_bias",
            torch.tensor(_INITIAL_GUESS[initial_guess], device=device),
            persistent=False,
        )

    @property
    def device(self) -> torch.device:
        return self.sdf.device

    def get_geometry(self, sdf_weight: float = 0.0):
        """(mesh, regularization, extracted)."""
        out = fc.extract(
            self.grid, self.sdf, self.deform,
            alpha=self.weights[:, :8], beta=self.weights[:, 8:20],
            gamma=self.weights[:, 20:],
        )
        reg = out.l_dev * 0.5 + gmath.abs_(self.weights[:, :20]).mean() * 0.1
        if sdf_weight > 0:
            reg = reg + fc.sdf_entropy(self.grid, self.sdf) * sdf_weight
        return out.mesh, reg, out

    def get_envmap(self):
        """(diffuse base, specular mips, white-balance regularization)."""
        cubemap = self.cubemap
        white_balance_reg = gmath.abs_(cubemap - cubemap.mean(-1, keepdim=True)).mean()
        base, mips = cm.prefilter_splitsum(cubemap)
        return base, mips, white_balance_reg

    def num_field_points(self, mesh: TriangleMesh) -> int:
        """Rows of the face-sampling jitter noise for this mesh."""
        return min(self.max_render_faces, mesh.num_faces)

    def render(
        self,
        cameras: Cameras,                    # batched [B]
        *,
        reg_weights: dict | None = None,     # sdf / light / kd_grad / ks_grad
        kd_perturb_std: float = 0.01,
        ks_perturb_std: float = 0.01,
        sampling: str = "face",
        jitter_noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Returns (rgba [B, H, W, 4] tone-mapped linear, regularization,
        aux). ``jitter_noise`` is the face-sampling jitter as a standard-
        normal [F, 3] draw; without it one is drawn from ``generator``."""
        w = {"sdf": 0.0, "light": 0.0, "kd_grad": 0.0, "ks_grad": 0.0}
        if reg_weights:
            w.update(reg_weights)
        with record_function("geosplat.geometry"):
            mesh, reg, extracted = self.get_geometry()
            reg = reg + fc.sdf_entropy(self.grid, self.sdf) * w["sdf"]

        use_jitter = self.smooth_type == "jitter"
        num_faces_valid = mesh.face_mask_or_ones().sum()
        if sampling not in ("face", "vertex"):
            raise ValueError(sampling)
        with record_function("geosplat.gaussians"):
            if sampling == "face":
                if use_jitter and jitter_noise is None:
                    jitter_noise = torch.randn(
                        (self.num_field_points(mesh), 3), generator=generator,
                        device=self.device,
                    )
                splats, attrs, _, valid = get_gaussians_from_face(
                    self.field, mesh, scale=self.scale,
                    initial_guess=self.initial_guess_bias,
                    kd_perturb_std=kd_perturb_std if use_jitter else 0.0,
                    ks_perturb_std=ks_perturb_std if use_jitter else 0.0,
                    jitter_noise=jitter_noise, max_faces=self.max_render_faces,
                )
            else:
                splats, attrs, valid = get_gaussians_from_vertex(
                    self.field, mesh, scale=self.scale,
                    initial_guess=self.initial_guess_bias,
                )
        with record_function("geosplat.envmap"):
            base, mips, light_reg = self.get_envmap()
        exposure = torch.exp(self.exposure[0])

        if attrs.kd_jitter is not None:
            reg = reg + w["kd_grad"] * gmath.abs_(attrs.kd_jitter - attrs.kd).mean()
        if attrs.ks_jitter is not None:
            reg = reg + w["ks_grad"] * gmath.abs_(attrs.ks_jitter - attrs.ks).mean()
        reg = reg + light_reg * w["light"]

        shade_attrs = dataclasses.replace(attrs, kd_jitter=None, ks_jitter=None)
        rgbas, totals = [], []
        for i in range(len(cameras)):
            with record_function("geosplat.shade_rasterize"):
                rgba, pair_info = shade_splitsum(
                    splats, shade_attrs, cameras[i], exposure=exposure,
                    env_base=base, env_mips=mips,
                    min_roughness=self.min_roughness, max_metallic=self.max_metallic,
                    pairs_per_gaussian=self.pairs_per_gaussian,
                    pairs_budget=self.pairs_budget, tile_shape=self.tile_shape,
                )
            rgbas.append(rgba)
            totals.append(pair_info["total_pairs"])
        aux = {
            "num_gaussians": valid.sum(),
            "num_surf_cubes": extracted.num_surf_cubes,
            "num_surf_edges": extracted.num_surf_edges,
            # overflow observables: silent truncation at either cap
            "num_faces_valid": num_faces_valid,
            "max_render_faces": self.max_render_faces,
            "total_pairs": torch.stack(totals).max(),
            "max_pairs": pair_info["max_pairs"],
        }
        return torch.stack(rgbas), reg, aux
