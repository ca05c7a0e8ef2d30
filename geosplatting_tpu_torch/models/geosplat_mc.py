"""GeoSplatterMC: stage 2 of GeoSplatting, Monte-Carlo environment shading
with SDF shadows.

Counterpart of ``geosplatting_tpu/models/geosplat_mc.py``: the model starts
from a stage-1 export (geometry, exposure, the roughness predictor, and the
environment cubemap resampled to a 256 x 512 lat-long table); per camera it
shades every Gaussian at its undisplaced surface position with ``env_shade``
(visibility sphere-traced through the live SDF), bends the normals toward
the camera, denoises the shading along the Gaussian axis, adds the residual
light sigmoid(occ - 3) times the shadowed fraction, rasterizes
(antialiased) and tone-maps (naive, ACES or none). With ``batched_binning``
every camera is binned in one pass ahead of the Monte-Carlo loop
(``bin_cameras_batched``; the opacities do not depend on the camera here)
and each camera composites from its bins. ``export_model`` and ``compact_export`` write
the stage-2 export that stage 3 loads; ``export_stage1`` writes the stage-1
one that ``init_from_stage1`` reads.

Randomness is explicit: ``render`` takes the face jitter noise and each
camera's ``ShadeDraws`` as tensors, or draws them from the caller's
``torch.Generator``. The field is the shared triplane field unless the
caller gives a ``GaussianField`` (with ``occ_enc=OCC_ENC``), whose stage-1
bundle is the hash grid's. Left out of the JAX model: ``tile_capacity``,
``tile_chunk`` and ``backend`` (the port has one rasterizer, the pairs
path).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import _kernels
from ..graphics import flexicubes as fc
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..ops import cubemap as cm
from ..ops import envshade as es
from ..ops.denoise import bilateral_denoise
from ..ops.hashgrid import HashGridConfig
from ..ops.rasterize import (
    bin_cameras_batched, camera_matrices, camera_slice, composite_from_bins, rasterize,
)
from ..ops.sdf_visibility import make_sdf_visibility
from .geosplat import (
    _INITIAL_GUESS, GaussianField, GeoSplatter, HashEncodingConfig, SharedField,
    export_ks_bundle, get_gaussians_from_face, ks_bundle_layout, load_ks_bundle, param_tree,
    tone_aces, tone_naive,
)

LATLNG_HW = (256, 512)

# the occ encoder of the hash field in stages 2 and prior (geosplat_mc.py:38-42)
OCC_ENC = HashEncodingConfig(
    grid=HashGridConfig(max_res=4096, log2_hashmap_size=18, grad_scaling=16.0),
    hidden=(32, 32), out_dim=6,
)


def cubemap_to_latlng(cube: torch.Tensor, height: int = 256, width: int = 512) -> torch.Tensor:
    """Bilinear resampling of a cubemap [6, R, R, C] to a lat-long table
    [height, width, C]."""
    dev = cube.device
    gy = (torch.arange(height, device=dev) + 0.5) / height * math.pi
    gx = ((torch.arange(width, device=dev) + 0.5) / width * 2.0 - 1.0) * math.pi
    theta, phi = torch.meshgrid(gy, gx, indexing="ij")
    sin_t = torch.sin(theta)
    dirs = torch.stack((sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)), -1)
    return cm.sample_cubemap(cube, dirs)


class GeoSplatterMC(nn.Module):
    """Stage-2 model. Parameters: ``sdf`` [V], ``deform`` [V, 3],
    ``weights`` [cubes, 21], ``latlng`` [256, 512, 3], ``exposure`` [1] and
    the ``field`` module (with the occ head; ``field`` gives a hash one).
    Runs on CUDA unless ``device`` says otherwise; ``init_from_stage1``
    fills it from a stage-1 export."""

    def __init__(
        self,
        *,
        background_color: str = "random",
        resolution: int = 32,
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
        batched_binning: bool = False,
        num_samples_x: int = 8,
        shadow_scale: float = 1.0,
        shadow_steps: int = 24,
        denoise: bool = True,
        triplane_resolution: int = 512,
        triplane_components: int = 32,
        field_hidden: int = 64,
        field: SharedField | GaussianField | None = None,
        generator: torch.Generator | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        device = _kernels.resolve_device(device)
        self.background_color = background_color
        self.resolution = resolution
        self.scale = scale
        self.min_roughness = min_roughness
        self.max_metallic = max_metallic
        self.initial_guess = initial_guess
        self.smooth_type = smooth_type
        self.max_render_faces = max_render_faces
        self.pairs_per_gaussian = pairs_per_gaussian
        self.pairs_budget = pairs_budget
        self.tile_shape = tile_shape
        self.batched_binning = batched_binning
        self.num_samples_x = num_samples_x
        self.shadow_scale = shadow_scale
        self.shadow_steps = shadow_steps
        self.denoise = denoise
        self.grid = fc.make_grid(resolution, scale=scale, surf_cube_budget=surf_cube_budget,
                                 surf_edge_budget=surf_edge_budget)
        g = self.grid
        self.sdf = nn.Parameter(torch.zeros(g.num_vertices, device=device))
        self.deform = nn.Parameter(torch.zeros((g.num_vertices, 3), device=device))
        self.weights = nn.Parameter(torch.zeros((g.num_cubes, 21), device=device))
        self.latlng = nn.Parameter(torch.full(LATLNG_HW + (3,), 0.5, device=device))
        self.exposure = nn.Parameter(torch.zeros(1, device=device))
        self.field = field if field is not None else SharedField(
            resolution=triplane_resolution, num_components=triplane_components,
            hidden=field_hidden, with_occ=True, generator=generator, device=device,
        )
        self.register_buffer(
            "initial_guess_bias", torch.tensor(_INITIAL_GUESS[initial_guess], device=device),
            persistent=False,
        )

    @property
    def device(self) -> torch.device:
        return self.sdf.device

    # ---- the stage-1 hand-off ------------------------------------------------
    @torch.no_grad()
    def init_from_stage1(self, export: dict) -> None:
        """Copy a stage-1 export (``export_stage1``, or ``load_export`` of its
        file) into the parameters: geometry, exposure and the roughness
        predictor (the trunk planes and the ks head, or the ks encoder of
        the hash field); the cubemap becomes the lat-long table. The other
        heads or encoders keep their fresh initialisation."""
        bundle = export["ks_enc"]
        hash_field = isinstance(self.field, GaussianField)
        if ks_bundle_layout(bundle) != ("hash" if hash_field else "triplane"):
            raise ValueError(
                "stage-1 ks export layout does not match the configured stage-2 field: "
                f"bundle keys {sorted(bundle)} vs a {type(self.field).__name__} — configure "
                "the same field family (SharedField vs GaussianField) for both stages")

        def f32(value) -> torch.Tensor:
            if isinstance(value, torch.Tensor):
                return value.detach().float()
            return torch.from_numpy(np.array(value, dtype=np.float32))

        def load(param: torch.Tensor, value, name: str) -> None:
            value = f32(value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"stage-1 export {name} has shape {tuple(value.shape)}, "
                                 f"the stage-2 model expects {tuple(param.shape)}")
            param.copy_(value.to(param.device))

        for name in ("sdf", "deform", "weights", "exposure"):
            load(getattr(self, name), export[name], name)
        cube = f32(export["cubemap"]).to(self.device)
        self.latlng.copy_(cubemap_to_latlng(cube, *LATLNG_HW))
        if hash_field:
            load_ks_bundle(self.field.ks_enc, bundle, "ks_enc")
            return
        load(self.field.trunk.planes, bundle["planes"], "ks_enc/planes")
        for name, p in self.field.ks.named_parameters():
            load(p, bundle["ks"][name], f"ks_enc/ks/{name}")

    # ---- pieces of the forward -----------------------------------------------
    def num_field_points(self) -> int:
        """Faces of the field evaluation (rows of the jitter noise): the
        extracted mesh's static face budget, capped at ``max_render_faces``."""
        return min(self.max_render_faces, 4 * self.grid.max_surf_edges)

    def draw_shade(self, generator: torch.Generator | None = None) -> es.ShadeDraws:
        """One camera's ``env_shade`` draws (6 Gaussians a face)."""
        return es.draw_shade(6 * self.num_field_points(), num_samples_x=self.num_samples_x,
                             generator=generator, device=self.device)

    def get_geometry(self):
        """(mesh, regularization, extracted)."""
        out = fc.extract(
            self.grid, self.sdf, self.deform,
            alpha=self.weights[:, :8], beta=self.weights[:, 8:20], gamma=self.weights[:, 20:],
        )
        reg = out.l_dev * 0.5 + gmath.abs_(self.weights[:, :20]).mean() * 0.1
        return out.mesh, reg, out

    def get_background(self, training: bool, generator: torch.Generator | None = None):
        if self.background_color == "black":
            return torch.zeros(3, device=self.device)
        if self.background_color == "white":
            return torch.ones(3, device=self.device)
        if training:
            return torch.rand(3, generator=generator, device=self.device)
        return torch.tensor([0.1490, 0.1647, 0.2157], device=self.device)

    def render(
        self,
        cameras: Cameras,                     # batched [B]
        *,
        reg_weights: dict | None = None,      # sdf / occ / kd_grad / ks_grad
        kd_perturb_std: float = 0.01,
        ks_perturb_std: float = 0.01,
        mode: str = "pbr",
        tone_type: str = "naive",
        exposure_override: torch.Tensor | None = None,
        jitter_noise: torch.Tensor | None = None,
        draws: list[es.ShadeDraws] | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Returns (rgba [B, H, W, 4] tone-mapped linear, regularization,
        aux). ``jitter_noise`` is the face jitter as a standard-normal
        [F, 3] draw and ``draws`` one ``ShadeDraws`` per camera; whatever is
        not given is drawn from ``generator``."""
        if mode not in ("pbr", "diffuse", "specular"):
            raise ValueError(f"mode: {mode!r}")
        if tone_type not in ("naive", "aces", "none"):
            raise ValueError(f"tone_type: {tone_type!r}")
        w = {"sdf": 0.0, "occ": 0.0, "kd_grad": 0.0, "ks_grad": 0.0}
        if reg_weights:
            w.update(reg_weights)
        with record_function("geosplat.geometry"):
            mesh, reg, extracted = self.get_geometry()
            reg = reg + fc.sdf_entropy(self.grid, self.sdf) * w["sdf"]
        use_jitter = self.smooth_type == "jitter"
        kd_std = kd_perturb_std if use_jitter else 0.0
        ks_std = ks_perturb_std if use_jitter else 0.0
        with record_function("geosplat.gaussians"):
            if (kd_std > 0 or ks_std > 0) and jitter_noise is None:
                jitter_noise = torch.randn(self.field.jitter_shape(self.num_field_points()),
                                           generator=generator, device=self.device)
            splats, attrs, offsets, valid = get_gaussians_from_face(
                self.field, mesh, scale=self.scale, initial_guess=self.initial_guess_bias,
                kd_perturb_std=kd_std, ks_perturb_std=ks_std, jitter_noise=jitter_noise,
                max_faces=self.max_render_faces,
            )
        if attrs.kd_jitter is not None:
            reg = reg + w["kd_grad"] * gmath.abs_(attrs.kd_jitter - attrs.kd).mean()
        if attrs.ks_jitter is not None:
            reg = reg + w["ks_grad"] * gmath.abs_(attrs.ks_jitter - attrs.ks).mean()
        reg = reg + w["occ"] * gmath.abs_(attrs.occ).mean()

        light = es.compute_light_pdf(self.latlng)
        exposure = torch.exp(self.exposure[0]) if exposure_override is None else exposure_override
        mc_positions = splats.means + offsets
        vis_fn = make_sdf_visibility(
            self.sdf, self.grid.resolution, self.scale, num_steps=self.shadow_steps,
        ) if self.shadow_scale > 0 else None
        roughness = attrs.ks[:, 0:1] * (1 - self.min_roughness) + self.min_roughness
        metallic = attrs.ks[:, 1:2] * self.max_metallic
        arm = torch.cat((torch.zeros_like(roughness), roughness, metallic), -1)
        kd_factor = attrs.kd * (1 - metallic)
        quats = gmath.safe_normalize(splats.quats)
        scales = torch.exp(splats.scales)
        opacities = torch.sigmoid(splats.opacities[:, 0])

        binned = None
        if self.batched_binning:
            viewmats, Ks = camera_matrices(cameras)
            binned = bin_cameras_batched(
                splats.means, quats, scales, opacities.expand(len(cameras), -1), viewmats, Ks,
                cameras.width, cameras.height, rasterize_mode="antialiased",
                pairs_per_gaussian=self.pairs_per_gaussian, max_pairs_override=self.pairs_budget,
                tile_size=self.tile_shape,
            )

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
            resi = torch.clamp(resi, 0.0, 1.0)
            if self.denoise:
                with record_function("geosplat.denoise"):
                    frag_depth = ((mc_positions - camera_pos) * camera_lookat).sum(-1, keepdim=True)
                    # one pass over the three signals: they share the guides,
                    # so each channel's weights are those of a separate pass
                    den = bilateral_denoise(
                        torch.cat((diff, spec, resi), -1)[None], frag_n[None], frag_depth[None],
                        sigma=max(self.shadow_scale * 2, 1e-4),
                    )[0]
                    diff, spec, resi = den[:, :3], den[:, 3:6], den[:, 6:]
            residual_light = torch.sigmoid(attrs.occ - 3.0)
            diff = diff + resi[:, 0:1] * residual_light[:, :3]
            spec = spec + resi[:, 1:2] * residual_light[:, 3:]
            if mode == "pbr":
                colors = diff * kd_factor + spec
            elif mode == "diffuse":
                colors = diff * kd_factor
            else:
                colors = spec
            if binned is None:
                render, alpha, info = rasterize(
                    splats.means, quats, scales, opacities, colors,
                    cam.view_matrix, cam.intrinsic_matrix, cam.width, cam.height,
                    rasterize_mode="antialiased", pairs_per_gaussian=self.pairs_per_gaussian,
                    max_pairs_override=self.pairs_budget, tile_size=self.tile_shape,
                )
            else:
                proj_b, bins_b, max_pairs = binned
                render, alpha, info = composite_from_bins(
                    camera_slice(proj_b, i), camera_slice(bins_b, i), colors,
                    max_pairs=max_pairs, width=cam.width, height=cam.height,
                    tile_size=self.tile_shape,
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
            "num_surf_cubes": extracted.num_surf_cubes,
            "num_surf_edges": extracted.num_surf_edges,
            # overflow observables: silent truncation at either cap
            "num_faces_valid": mesh.face_mask_or_ones().sum(),
            "max_render_faces": self.max_render_faces,
            "total_pairs": torch.stack(totals).max(),
            "max_pairs": min(self.pairs_per_gaussian * n, self.pairs_budget or (1 << 62)),
        }
        return torch.stack(rgbas), reg, aux

    # ---- the stage-3 hand-off --------------------------------------------------
    @torch.no_grad()
    def export_model(self) -> dict:
        """The stage-2 export (keys and layout of the JAX package's
        ``export_model``), as detached tensors and Python scalars; padded to
        the face budget (``compact_export`` keeps the live rows)."""
        mesh, _, _ = self.get_geometry()
        splats, attrs, offsets, valid = get_gaussians_from_face(
            self.field, mesh, scale=self.scale, initial_guess=self.initial_guess_bias,
            max_faces=self.max_render_faces,
        )
        return {
            "geom_scale": self.scale,
            "resolution": self.resolution,
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
            "occ_enc": param_tree(self.field.occ_enc) if isinstance(self.field, GaussianField)
            else {
                "planes": self.field.trunk.planes.detach(),
                "occ": {name: p.detach() for name, p in self.field.occ.named_parameters()},
            },
            "mc_positions": splats.means + offsets,
            "mc_vertices": mesh.vertices,
            "mc_indices": mesh.indices.to(torch.int32),
            "mc_face_mask": mesh.face_mask_or_ones(),
            "gaussian_mask": valid,
            "sdf": self.sdf.detach(),
            "deform": self.deform.detach(),
            "initial_guess": self.initial_guess_bias,
        }


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def compact_export(export: dict, pad_to: int = 4096) -> dict:
    """A stage-2 export cut to its live Gaussians, as numpy arrays: the
    valid rows of every per-Gaussian array, padded to a multiple of
    ``pad_to`` with dead rows (mask False, raw opacity and log-scales -10,
    unit quaternions)."""
    export = _to_numpy(export)
    mask = np.asarray(export["gaussian_mask"]).astype(bool)
    n_live = int(mask.sum())
    n_out = max(-(-n_live // pad_to) * pad_to, pad_to)
    idx = np.flatnonzero(mask)
    out = dict(export)
    for k in ("means", "scales", "quats", "opacities", "normals", "kd", "ks", "occ",
              "mc_positions"):
        if export.get(k) is None:
            continue
        a = np.asarray(export[k])
        b = np.zeros((n_out,) + a.shape[1:], a.dtype)
        b[:n_live] = a[idx]
        if k in ("opacities", "scales"):
            b[n_live:] = -10.0     # sigmoid ~ 0 and tiny: pad rows never render
        if k == "quats":
            b[n_live:, 0] = 1.0    # normalizable unit quaternions
        out[k] = b
    m = np.zeros((n_out,), bool)
    m[:n_live] = True
    out["gaussian_mask"] = m
    return out


def export_stage1(model: GeoSplatter) -> dict:
    """The stage-1 export (keys and layout of the JAX package's
    ``export_stage1``), as detached tensors and Python scalars."""
    with torch.no_grad():
        return {
            "geom_scale": model.scale,
            "resolution": model.resolution,
            "min_roughness": model.min_roughness,
            "max_metallic": model.max_metallic,
            "exposure": model.exposure.detach(),
            "cubemap": model.cubemap.detach(),
            "deform": model.deform.detach(),
            "weights": model.weights.detach(),
            "sdf": model.sdf.detach(),
            "ks_enc": export_ks_bundle(model.field),
            "initial_guess": model.initial_guess_bias.detach(),
        }
