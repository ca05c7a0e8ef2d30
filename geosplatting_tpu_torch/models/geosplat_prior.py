"""GeoSplatterPrior: the mesh-prior variant of GeoSplatting.

Counterpart of ``geosplatting_tpu/models/geosplat_prior.py``: the vertices
of a user-supplied mesh (``graphics/mesh_io.py``) are optimised through a
learnable offset ``deform`` under the uniform-Laplacian, normal-consistency,
edge-length and offset regularizers; MGAdapter Gaussians (6 a face) take
their materials from the material field (``smooth_type="jitter"``, with the
jitter smoothness terms) or from direct per-Gaussian ``kdks`` / ``zs``
parameters; per camera every Gaussian is shaded with ``env_shade`` against
a 256 x 512 lat-long light, its shadows marched through the occupancy grid
of the live mesh (``make_mesh_visibility``, the BVH-free stand-in of the
reference's shadow rays), the normals bent toward the camera, the shading
denoised along the Gaussian axis, the residual light sigmoid(occ - 3) times
the shadowed fraction added; then antialiased rasterization and tone
mapping. ``export_model`` writes the JAX package's export.

Randomness is explicit: ``render`` takes the field's jitter noise, the
visibility grid's surface draws and each camera's ``ShadeDraws`` as
tensors, or draws them, in that order, from the caller's
``torch.Generator``. Left out of the JAX model: ``tile_capacity``,
``tile_chunk``, ``chunk_size`` and ``backend`` (the port has one
rasterizer, the pairs path), and ``background_color``,
``max_render_faces`` and ``field_eval_chunk``, which no caller sets (the
trainer composites over a random background, a prior mesh is not padded,
the field's chunk is ``get_gaussians_from_face``'s default).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from .. import _kernels
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.mesh import (
    TriangleMesh, mesh_edge_loss, mesh_normal_consistency, uniform_laplacian_smoothing,
)
from ..ops import envshade as es
from ..ops.denoise import bilateral_denoise
from ..ops.rasterize import rasterize
from ..ops.sdf_visibility import make_mesh_visibility
from .geosplat import (
    GaussianField, MGAdapter, RenderableAttrs, SharedField, export_ks_bundle,
    get_gaussians_from_face, tone_aces, tone_naive,
)
from .geosplat_mc import LATLNG_HW

# surface samples of the occupancy grid (sdf_visibility.py:147, fixed there)
VISIBILITY_SAMPLES = 1 << 17


def z_up_to_y_up(vertices: torch.Tensor) -> torch.Tensor:
    """Axis permutation (y, z, x), x and z flipped, scaled by 1.25 * 2/3."""
    v = vertices[..., [1, 2, 0]] * vertices.new_tensor([-1.0, 1.0, -1.0])
    return v * (1.25 * 2 / 3)


class GeoSplatterPrior(nn.Module):
    """The mesh-prior model over ``base_mesh`` (its vertices and indices are
    buffers, not parameters). Parameters: ``deform`` [V, 3], ``latlng``
    [256, 512, 3], ``exposure`` [1], the ``field`` module (a
    ``SharedField(with_occ=True)`` of ``triplane_*`` unless ``field`` gives
    one: a ``GaussianField`` selects the hash grid) and, unless
    ``smooth_type`` is "jitter", ``kdks`` [6F, 5] and ``zs`` [6F, 1]. Runs
    on CUDA unless ``device`` says otherwise."""

    def __init__(
        self,
        base_mesh: TriangleMesh,
        *,
        smooth_type: str = "jitter",
        min_roughness: float = 0.1,
        max_metallic: float = 1.0,
        scale: float = 1.0,
        field: SharedField | GaussianField | None = None,
        num_samples_x: int = 8,
        shadow_scale: float = 0.95,
        visibility_resolution: int = 64,
        denoise: bool = True,
        pairs_per_gaussian: int = 6,
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
        self.smooth_type = smooth_type
        self.min_roughness = min_roughness
        self.max_metallic = max_metallic
        self.scale = scale
        self.num_samples_x = num_samples_x
        self.shadow_scale = shadow_scale
        self.visibility_resolution = visibility_resolution
        self.denoise = denoise
        self.pairs_per_gaussian = pairs_per_gaussian
        self.pairs_budget = pairs_budget
        self.tile_shape = tile_shape
        self.register_buffer("base_vertices", base_mesh.vertices.detach().float().to(device),
                             persistent=False)
        self.register_buffer("base_indices", base_mesh.indices.long().to(device),
                             persistent=False)
        self.deform = nn.Parameter(torch.zeros_like(self.base_vertices))
        self.latlng = nn.Parameter(torch.full(LATLNG_HW + (3,), 0.5, device=device))
        self.exposure = nn.Parameter(torch.zeros(1, device=device))
        self.field = field if field is not None else SharedField(
            resolution=triplane_resolution, num_components=triplane_components,
            hidden=field_hidden, with_occ=True, generator=generator, device=device,
        )
        if smooth_type != "jitter":
            n = 6 * self.num_faces
            self.kdks = nn.Parameter(torch.zeros((n, 5), device=device))
            self.zs = nn.Parameter(torch.zeros((n, 1), device=device))
        self.register_buffer("initial_guess_bias", torch.zeros(2, device=device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.deform.device

    @property
    def num_faces(self) -> int:
        return self.base_indices.shape[0]

    # ---- pieces of the forward -----------------------------------------------
    def get_geometry(self) -> tuple[TriangleMesh, torch.Tensor]:
        """(the deformed mesh, its regularization)."""
        mesh = TriangleMesh(vertices=self.base_vertices + self.deform, indices=self.base_indices)
        reg = (uniform_laplacian_smoothing(mesh) * 1e-3
               + mesh_normal_consistency(mesh) * 3e-4
               + mesh_edge_loss(mesh) * 0.1
               + (self.deform ** 2).sum(-1).mean() * 0.1)
        return mesh, reg

    @torch.no_grad()
    def draw_visibility(self, generator: torch.Generator | None = None):
        """The visibility grid's surface draws (face ids, uniforms) on the
        current mesh."""
        mesh = TriangleMesh(vertices=self.base_vertices + self.deform, indices=self.base_indices)
        return mesh.draw_surface(VISIBILITY_SAMPLES, generator)

    def draw_shade(self, generator: torch.Generator | None = None) -> es.ShadeDraws:
        """One camera's ``env_shade`` draws (every Gaussian)."""
        return es.draw_shade(6 * self.num_faces, num_samples_x=self.num_samples_x,
                             generator=generator, device=self.device)

    def gaussians(self, mesh: TriangleMesh, kd_perturb_std: float, ks_perturb_std: float,
                  jitter_noise: torch.Tensor | None):
        """(splats, attrs, offsets, valid) of the field or, without the
        jitter smoothing, of the direct parameters."""
        if self.smooth_type == "jitter":
            return get_gaussians_from_face(
                self.field, mesh, scale=self.scale, initial_guess=self.initial_guess_bias,
                kd_perturb_std=kd_perturb_std, ks_perturb_std=ks_perturb_std,
                jitter_noise=jitter_noise,
            )
        splats, offsets, valid = MGAdapter().make(mesh)
        offsets = offsets * torch.sigmoid(self.zs)
        splats = splats.replace(means=splats.means - offsets)
        attrs = RenderableAttrs(
            kd=torch.sigmoid(self.kdks[:, :3]),
            ks=torch.sigmoid(self.kdks[:, 3:] + self.initial_guess_bias),
            normals=splats.colors,
        )
        return splats, attrs, offsets, valid

    def render(
        self,
        cameras: Cameras,                     # batched [B]
        *,
        reg_weights: dict | None = None,      # occ / kd_grad / ks_grad
        kd_perturb_std: float = 0.01,
        ks_perturb_std: float = 0.01,
        tone_type: str = "naive",
        jitter_noise: torch.Tensor | None = None,
        surface_draws: tuple[torch.Tensor, torch.Tensor] | None = None,
        draws: list[es.ShadeDraws] | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Returns (rgba [B, H, W, 4] tone-mapped linear, regularization,
        aux). ``jitter_noise`` is the field's jitter (a standard-normal draw
        of ``field.jitter_shape``), ``surface_draws`` the visibility grid's
        (``draw_visibility``) and ``draws`` one ``ShadeDraws`` per camera;
        whatever is not given is drawn from ``generator``."""
        if tone_type not in ("naive", "aces", "none"):
            raise ValueError(f"tone_type: {tone_type!r}")
        w = {"occ": 0.0, "kd_grad": 0.0, "ks_grad": 0.0}
        if reg_weights:
            w.update(reg_weights)
        with record_function("prior.geometry"):
            mesh, reg = self.get_geometry()
        with record_function("prior.gaussians"):
            jitter = self.smooth_type == "jitter" and (kd_perturb_std > 0 or ks_perturb_std > 0)
            if jitter and jitter_noise is None:
                jitter_noise = torch.randn(self.field.jitter_shape(self.num_faces),
                                           generator=generator, device=self.device)
            splats, attrs, offsets, valid = self.gaussians(mesh, kd_perturb_std, ks_perturb_std,
                                                           jitter_noise)
        if attrs.kd_jitter is not None:
            reg = reg + w["kd_grad"] * gmath.abs_(attrs.kd_jitter - attrs.kd).mean()
        if attrs.ks_jitter is not None:
            reg = reg + w["ks_grad"] * gmath.abs_(attrs.ks_jitter - attrs.ks).mean()
        if attrs.occ is not None:
            reg = reg + w["occ"] * gmath.abs_(attrs.occ).mean()

        light = es.compute_light_pdf(self.latlng)
        exposure = torch.exp(self.exposure[0])
        mc_positions = splats.means + offsets
        vis_fn = None
        if self.shadow_scale > 0:
            with record_function("prior.visibility_grid"):
                if surface_draws is None:
                    surface_draws = self.draw_visibility(generator)
                vis_mesh = TriangleMesh(vertices=mesh.vertices.detach(), indices=mesh.indices)
                vis_fn = make_mesh_visibility(
                    vis_mesh, resolution=self.visibility_resolution, scale=self.scale * 1.05,
                    num_samples=VISIBILITY_SAMPLES, draws=surface_draws)
        roughness = attrs.ks[:, 0:1] * (1 - self.min_roughness) + self.min_roughness
        metallic = attrs.ks[:, 1:2] * self.max_metallic
        arm = torch.cat((torch.zeros_like(roughness), roughness, metallic), -1)
        kd_factor = attrs.kd * (1 - metallic)
        quats = gmath.safe_normalize(splats.quats)
        scales = torch.exp(splats.scales)
        opacities = torch.sigmoid(splats.opacities[:, 0])

        rgbas, totals = [], []
        for i in range(len(cameras)):
            cam = cameras[i]
            camera_pos = cam.c2w[:, 3]
            camera_lookat = -cam.c2w[:, 2]
            bend = (attrs.normals.detach() * camera_lookat).sum(-1, keepdim=True) > 1e-3
            frag_n = torch.where(bend, -attrs.normals, attrs.normals)
            draws_i = draws[i] if draws is not None else self.draw_shade(generator)
            diff, spec, resi = es.env_shade(
                mc_positions, frag_n, camera_pos, attrs.kd, arm, light, draws_i,
                visibility_fn=vis_fn, shadow_scale=self.shadow_scale,
            )
            diff = torch.clamp(diff, min=1e-4)
            spec = torch.clamp(spec, min=1e-4)
            if self.denoise:
                with record_function("prior.denoise"):
                    frag_depth = ((mc_positions - camera_pos) * camera_lookat).sum(-1, keepdim=True)
                    # one pass over both signals: they share the guides, so
                    # each channel's weights are those of a separate pass
                    den = bilateral_denoise(torch.cat((diff, spec), -1)[None], frag_n[None],
                                            frag_depth[None], sigma=2.0)[0]
                    diff, spec = den[:, :3], den[:, 3:]
            if attrs.occ is not None:
                residual_light = torch.sigmoid(attrs.occ - 3.0)
                resi = torch.clamp(resi, 0.0, 1.0)
                diff = diff + resi[:, 0:1] * residual_light[:, :3]
                spec = spec + resi[:, 1:2] * residual_light[:, 3:]
            colors = diff * kd_factor + spec
            render, alpha, info = rasterize(
                splats.means, quats, scales, opacities, colors,
                cam.view_matrix, cam.intrinsic_matrix, cam.width, cam.height,
                rasterize_mode="antialiased", pairs_per_gaussian=self.pairs_per_gaussian,
                max_pairs_override=self.pairs_budget, tile_size=self.tile_shape,
            )
            rgb = render[..., :3]
            if tone_type == "naive":
                rgb = tone_naive(rgb, exposure)
            elif tone_type == "aces":
                rgb = tone_aces(rgb, exposure)
            else:
                rgb = rgb * exposure
            rgbas.append(torch.cat((rgb, alpha), -1))
            totals.append(info["total_pairs"])
        n = splats.means.shape[0]
        aux = {
            "num_gaussians": valid.sum(),
            "total_pairs": torch.stack(totals).max(),
            "max_pairs": min(self.pairs_per_gaussian * n, self.pairs_budget or (1 << 62)),
        }
        return torch.stack(rgbas), reg, aux

    @torch.no_grad()
    def export_model(self) -> dict:
        """The prior's export (keys and layout of the JAX package's
        ``export_model``; ``sdf`` and ``mc_face_mask`` are None), as detached
        tensors and Python scalars."""
        mesh, _ = self.get_geometry()
        splats, attrs, offsets, _ = get_gaussians_from_face(
            self.field, mesh, scale=self.scale, initial_guess=self.initial_guess_bias)
        return {
            "geom_scale": self.scale,
            "min_roughness": self.min_roughness,
            "max_metallic": self.max_metallic,
            "exposure": self.exposure.detach(),
            "latlng": self.latlng.detach(),
            "means": splats.means,
            "scales": splats.scales,
            "quats": splats.quats,
            "opacities": splats.opacities,
            "normals": attrs.normals,
            "kd": attrs.kd,
            "ks": attrs.ks,
            "occ": attrs.occ,
            "ks_enc": export_ks_bundle(self.field),
            "mc_positions": splats.means + offsets,
            "mc_vertices": mesh.vertices,
            "mc_indices": mesh.indices.to(torch.int32),
            "mc_face_mask": None,
            "sdf": None,
            "initial_guess": self.initial_guess_bias,
        }
