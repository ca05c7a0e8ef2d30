"""GeoSplatterDefer: stage 3 of GeoSplatting, deferred PBR shading of a
G-buffer, and the relighting renders of the evaluation.

Counterpart of ``geosplatting_tpu/models/geosplat_defer.py``: the model
starts from a stage-2 export, with the Gaussians as direct parameters, the
roughness predictor (triplane trunk and head) trainable, and the lat-long
light split into a hue in (0, 1) and a log value. Per camera it rasterizes
a 14-channel G-buffer (normals bent toward the camera, kd, roughness /
metallic, occ) through the pairs rasterizer and divides it by the detached
alpha, rasterizes the frozen stage-2 mesh for each pixel's surface position,
shades every pixel with ``env_shade`` (SDF shadows through the frozen SDF),
adds the residual light sigmoid(occ - 3) times the shadowed fraction,
composites over alpha and tone-maps. With ``batched_binning`` every
camera's G-buffer pairs are binned in one pass ahead of the loop
(``bin_cameras_batched``), fed each camera's opacities with its back-facing
Gaussians killed, and each camera composites from its bins.
``render_attribute`` rasterizes kd,
roughness / metallic or normals for the regularization and the evaluation;
``albedo_scaling`` with a relight environment gives the relit renders.
The stage-3 export's ``params`` are ``convert.params_to_numpy`` of the
state dict.

Randomness is explicit: ``render`` takes the ks jitter noise and each
camera's ``ShadeDraws`` as tensors, or draws them from the caller's
``torch.Generator``. The roughness predictor is the stage-2 export's:
the triplane trunk and head (``KsBundle``) or, for an export of the hash
field, a ``HashEncoding`` (``ks_hash``, the JAX model's ``KS_ENC`` for a
task). Left out of the JAX model: ``tile_capacity``, ``tile_chunk``,
``chunk_size`` and ``backend`` (the port has one rasterizer, the pairs
path). As in the JAX model, ``render_attribute`` (the trainer's kd and
normal maps) bins camera by camera whatever ``batched_binning`` says. The
frozen mesh's raster keeps every triangle: its tile capacity is at least
the mesh's face count, where the JAX model keeps ``mesh_tile_capacity`` a
tile and drops the rest without a word (small images put thousands of
triangles in one 16 x 16 tile).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import _kernels
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.mesh import TriangleMesh
from ..ops import envshade as es
from ..ops.hashgrid import HashGridConfig
from ..ops.mesh_raster import interpolate, rasterize_mesh
from ..ops.rasterize import (
    bin_cameras_batched, camera_matrices, camera_slice, composite_from_bins, rasterize,
)
from ..ops.sdf_visibility import make_sdf_visibility
from .geosplat import (
    HashEncoding, HashEncodingConfig, KsBundle, check_ks_bundle, load_ks_bundle, tone_aces,
    tone_naive,
)
from .geosplat_mc import LATLNG_HW

# the hash-grid roughness predictor of stage 3 (geosplat_defer.py:34-38)
KS_ENC = HashEncodingConfig(
    grid=HashGridConfig(max_res=4096, log2_hashmap_size=18, grad_scaling=16.0),
    hidden=(32,), out_dim=2,
)

GAUSSIAN_PARAMS = ("means", "scales", "quats", "opacities", "normals", "kd", "occ")
_WIDTHS = {"means": 3, "scales": 3, "quats": 4, "opacities": 1, "normals": 3, "kd": 3, "occ": 6}


def _tensor(value, device, dtype=torch.float32) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(value), device=device).to(dtype)


def frozen_geometry(export: Mapping) -> dict:
    """The stage-2 geometry the forward reads and never trains, under the
    stage-3 export's names, as the export stores it: the mesh (vertices,
    indices, face mask), the initial-guess logits and the SDF."""
    return {"mesh_v": export["mc_vertices"], "mesh_i": export["mc_indices"],
            "mesh_mask": export.get("mc_face_mask"), "initial_guess": export["initial_guess"],
            "sdf": export["sdf"]}


class GeoSplatterDefer(nn.Module):
    """Stage-3 model over ``num_gaussians`` Gaussians. Parameters: the
    per-Gaussian ``means``, ``scales`` (log), ``quats``, ``opacities``
    (logit), ``normals``, ``kd``, ``occ``; ``exposure`` [1];
    ``latlng_hue`` and ``latlng_value`` [256, 512, 3]; the ``ks_enc``
    module (a triplane of ``ks_resolution`` x ``ks_components`` and its
    head, or with ``ks_hash`` that hash grid and its head).
    Runs on CUDA unless ``device`` says otherwise;
    ``init_from_stage2`` fills it from a stage-2 export and ``set_geometry``
    gives it the frozen stage-2 geometry."""

    def __init__(
        self,
        *,
        num_gaussians: int,
        ks_resolution: int = 512,
        ks_components: int = 32,
        ks_hash: HashEncodingConfig | None = None,
        background_color: str = "random",
        min_roughness: float = 0.1,
        max_metallic: float = 1.0,
        scale: float = 1.05,
        resolution: int = 32,
        num_samples_x: int = 4,
        shadow_scale: float = 1.0,
        shadow_steps: int = 24,
        pairs_per_gaussian: int = 6,
        pairs_budget: int | None = None,
        tile_shape: str = "16",
        batched_binning: bool = False,
        mesh_tile_capacity: int = 256,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        device = _kernels.resolve_device(device)
        self.background_color = background_color
        self.min_roughness = min_roughness
        self.max_metallic = max_metallic
        self.scale = scale
        self.resolution = resolution
        self.num_samples_x = num_samples_x
        self.shadow_scale = shadow_scale
        self.shadow_steps = shadow_steps
        self.pairs_per_gaussian = pairs_per_gaussian
        self.pairs_budget = pairs_budget
        self.tile_shape = tile_shape
        self.batched_binning = batched_binning
        self.mesh_tile_capacity = mesh_tile_capacity
        for name in GAUSSIAN_PARAMS:
            self.register_parameter(name, nn.Parameter(
                torch.zeros((num_gaussians, _WIDTHS[name]), device=device)))
        self.exposure = nn.Parameter(torch.zeros(1, device=device))
        self.latlng_hue = nn.Parameter(torch.full(LATLNG_HW + (3,), 0.5, device=device))
        self.latlng_value = nn.Parameter(torch.zeros(LATLNG_HW + (3,), device=device))
        self.ks_enc = (KsBundle(ks_resolution, ks_components, device=device)
                       if ks_hash is None else HashEncoding(ks_hash, device=device))
        self.geometry: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def mesh_raster_capacity(self) -> int:
        """Triangles kept a tile: no tile holds more than every face, and
        the raster resolves only as deep as the fullest tile, so the face
        count as a floor drops nothing and costs nothing where unused."""
        return max(self.mesh_tile_capacity, self.mesh.indices.shape[0])

    # ---- the stage-2 hand-off ------------------------------------------------
    @torch.no_grad()
    def init_from_stage2(self, export: Mapping) -> None:
        """Copy a stage-2 export (``compact_export``, or ``load_export`` of
        its file) into the parameters and take its frozen geometry; the
        lat-long light L becomes hue L / (L + 1) and value log(L + 1.00001)."""
        bundle = export["ks_enc"]
        layout = check_ks_bundle(bundle)
        if layout != ("triplane" if isinstance(self.ks_enc, KsBundle) else "hash"):
            raise ValueError(f"the stage-2 export's roughness predictor is the {layout} "
                             "layout; build the stage-3 model for it (ks_hash)")

        def load(param: torch.Tensor, value, name: str) -> None:
            value = _tensor(value, self.device)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"stage-2 export {name} has shape {tuple(value.shape)}, "
                                 f"the stage-3 model expects {tuple(param.shape)}")
            param.copy_(value)

        for name in (*GAUSSIAN_PARAMS, "exposure"):
            load(getattr(self, name), export[name], name)
        latlng = _tensor(export["latlng"], self.device)
        load(self.latlng_hue, latlng / (latlng + 1.0), "latlng")
        load(self.latlng_value, torch.log(latlng + 1.00001), "latlng")
        load_ks_bundle(self.ks_enc, bundle, "ks_enc")
        self.set_geometry(frozen_geometry(export))

    def set_geometry(self, geometry: Mapping) -> None:
        """The frozen stage-2 geometry (``frozen_geometry``, or the
        ``geometry`` of a stage-3 export), on the model's device."""
        mask = geometry.get("mesh_mask")
        g = {k: _tensor(geometry[k], self.device) for k in ("mesh_v", "initial_guess", "sdf")}
        g["mesh_i"] = _tensor(geometry["mesh_i"], self.device, torch.long)
        g["mesh_mask"] = None if mask is None else _tensor(mask, self.device, torch.bool)
        self.geometry = g
        self.mesh = TriangleMesh(vertices=g["mesh_v"], indices=g["mesh_i"],
                                 face_mask=g["mesh_mask"])

    # ---- pieces of the forward -----------------------------------------------
    def draw_shade(self, cameras: Cameras, generator: torch.Generator | None = None,
                   num_samples_x: int | None = None) -> es.ShadeDraws:
        """One camera's ``env_shade`` draws (one point a pixel)."""
        return es.draw_shade(cameras.width * cameras.height,
                             num_samples_x=num_samples_x or self.num_samples_x,
                             generator=generator, device=self.device)

    def get_background(self, training: bool, generator: torch.Generator | None = None):
        if self.background_color == "black":
            return torch.zeros(3, device=self.device)
        if self.background_color == "white":
            return torch.ones(3, device=self.device)
        if training:
            return torch.rand(3, generator=generator, device=self.device)
        return torch.tensor([0.1490, 0.1647, 0.2157], device=self.device)

    def get_envmap(self, relight_envmap: torch.Tensor | None = None) -> es.LightPdf:
        if relight_envmap is not None:
            return es.compute_light_pdf(relight_envmap)
        return es.compute_light_pdf(self.latlng_hue * torch.exp(self.latlng_value))

    def gaussian_ks(self) -> torch.Tensor:
        """Per-Gaussian (roughness, metallic) in (0, 1), before the remap."""
        x = torch.clamp(self.means / self.scale, -1, 1)
        return torch.sigmoid(self.ks_enc(x) + self.geometry["initial_guess"])

    def _rasterize(self, colors, opacities, cam, **kw):
        return rasterize(
            self.means, gmath.safe_normalize(self.quats), torch.exp(self.scales),
            torch.sigmoid(opacities[:, 0]), colors, cam.view_matrix, cam.intrinsic_matrix,
            cam.width, cam.height, rasterize_mode="antialiased", tile_size=self.tile_shape, **kw)

    def render(
        self,
        cameras: Cameras,                     # batched [B]
        *,
        ks_weight: float = 0.0,
        mode: str = "pbr",
        tone_type: str = "naive",
        relight_envmap: torch.Tensor | None = None,
        albedo_scaling: torch.Tensor | None = None,
        num_samples_override: int | None = None,
        jitter_noise: torch.Tensor | None = None,
        draws: list[es.ShadeDraws] | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Returns (rgba [B, H, W, 4], regularization, aux). ``jitter_noise``
        is the ks jitter as a standard-normal [N, 3] draw (read only when
        ``ks_weight`` > 0) and ``draws`` one ``ShadeDraws`` per camera;
        whatever is not given is drawn from ``generator``."""
        if mode not in ("pbr", "diffuse", "specular"):
            raise ValueError(f"mode: {mode!r}")
        if tone_type not in ("naive", "aces", "none"):
            raise ValueError(f"tone_type: {tone_type!r}")
        if self.geometry is None:
            raise RuntimeError("no frozen geometry: call init_from_stage2 or set_geometry")
        geo = self.geometry
        normals = gmath.safe_normalize(self.normals)
        means = self.means
        with record_function("defer.ks"):
            ks = self.gaussian_ks()
            reg = means.new_zeros(())
            if ks_weight > 0:
                if jitter_noise is None:
                    jitter_noise = torch.randn(means.shape, generator=generator,
                                               device=self.device)
                jit_in = torch.clamp((means + jitter_noise * 0.01) / self.scale, -1, 1)
                ks_jitter = torch.sigmoid(self.ks_enc(jit_in) + geo["initial_guess"])
                reg = gmath.abs_(ks - ks_jitter).mean() * ks_weight

        kd = self.kd
        occ = self.occ
        if albedo_scaling is not None:
            # relighting: scale the albedo, collapse occ to its mean
            occ = occ.mean(-1, keepdim=True) * torch.cat((torch.ones_like(kd), kd), -1)
            kd = kd * albedo_scaling
        light = self.get_envmap(relight_envmap)
        exposure = torch.exp(self.exposure[0]) if albedo_scaling is None else 1.0
        vis_fn = make_sdf_visibility(
            geo["sdf"], (self.resolution,) * 3, self.scale, num_steps=self.shadow_steps,
        ) if self.shadow_scale > 0 else None
        nsx = num_samples_override or self.num_samples_x

        bends = [(normals.detach() * -cameras[i].c2w[:, 2]).sum(-1, keepdim=True) > 0
                 for i in range(len(cameras))]
        binned = None
        if self.batched_binning:
            # the per-camera kill of back-facing Gaussians feeds the binning
            opac_b = torch.stack([torch.sigmoid(torch.where(bend, -2.0, self.opacities)[:, 0])
                                  for bend in bends])
            viewmats, Ks = camera_matrices(cameras)
            binned = bin_cameras_batched(
                means, gmath.safe_normalize(self.quats), torch.exp(self.scales), opac_b,
                viewmats, Ks, cameras.width, cameras.height, rasterize_mode="antialiased",
                pairs_per_gaussian=self.pairs_per_gaussian, max_pairs_override=self.pairs_budget,
                tile_size=self.tile_shape,
            )

        rgbas, totals, tile_fill, mesh_pair_fill = [], [], [], []
        for i in range(len(cameras)):
            cam = cameras[i]
            camera_pos = cam.c2w[:, 3]
            bend = bends[i]
            frag_normals = torch.where(bend, -normals, normals)
            with record_function("defer.gbuffer"):
                gbuf = torch.cat((frag_normals, kd, ks, occ), -1)   # 14 channels
                if binned is None:
                    render, alpha, info = self._rasterize(
                        gbuf, torch.where(bend, -2.0, self.opacities), cam,
                        pairs_per_gaussian=self.pairs_per_gaussian,
                        max_pairs_override=self.pairs_budget)
                else:
                    proj_b, bins_b, max_pairs = binned
                    render, alpha, info = composite_from_bins(
                        camera_slice(proj_b, i), camera_slice(bins_b, i), gbuf,
                        max_pairs=max_pairs, width=cam.width, height=cam.height,
                        tile_size=self.tile_shape,
                    )
            render = render / torch.clamp(alpha.detach(), min=1e-6)
            frag_n = gmath.safe_normalize(render[..., 0:3])
            frag_kd = render[..., 3:6]
            frag_rough = render[..., 6:7] * (1 - self.min_roughness) + self.min_roughness
            frag_metal = render[..., 7:8] * self.max_metallic
            frag_occ = render[..., 8:14]
            with record_function("defer.mesh_raster"), torch.no_grad():
                rast, mesh_info = rasterize_mesh(self.mesh, cam,
                                                 tile_capacity=self.mesh_raster_capacity)
                frag_pos = interpolate(self.mesh.vertices, self.mesh, rast)

            hw = cam.height * cam.width
            arm = torch.cat((torch.zeros_like(frag_rough), frag_rough, frag_metal), -1)
            draws_i = draws[i] if draws is not None else self.draw_shade(cam, generator, nsx)
            diff, spec, resi = es.env_shade(
                frag_pos.reshape(hw, 3), frag_n.reshape(hw, 3), camera_pos,
                frag_kd.reshape(hw, 3), arm.reshape(hw, 3), light, draws_i,
                visibility_fn=vis_fn, shadow_scale=self.shadow_scale,
            )
            sh = (cam.height, cam.width)
            diff = torch.clamp(diff.reshape(sh + (3,)), min=1e-4)
            spec = torch.clamp(spec.reshape(sh + (3,)), min=1e-4)
            resi = torch.clamp(resi.reshape(sh + (2,)), 0.0, 1.0)
            residual_light = torch.sigmoid(frag_occ - 3.0)
            diff = diff + resi[..., 0:1] * residual_light[..., :3]
            spec = spec + resi[..., 1:2] * residual_light[..., 3:]
            kd_factor = frag_kd * (1 - frag_metal)
            if mode == "pbr":
                colors = diff * kd_factor + spec
            elif mode == "diffuse":
                colors = diff * kd_factor
            else:
                colors = spec
            rgb = colors * alpha.detach()
            if tone_type == "naive":
                rgb = tone_naive(rgb, exposure)
            elif tone_type == "aces":
                rgb = tone_aces(rgb, exposure)
            else:
                rgb = rgb * exposure
            rgbas.append(torch.cat((rgb, alpha), -1))
            totals.append(info["total_pairs"])
            tile_fill.append(mesh_info.tile_fill)
            mesh_pair_fill.append(mesh_info.pair_fill)
        n = self.num_gaussians
        aux = {
            "num_gaussians": n,
            "total_pairs": torch.stack(totals).max(),
            "max_pairs": min(self.pairs_per_gaussian * n, self.pairs_budget or (1 << 62)),
            # the mesh raster's budgets: > 1 means dropped triangles
            "mesh_tile_fill": max(tile_fill),
            "mesh_pair_fill": max(mesh_pair_fill),
        }
        return torch.stack(rgbas), reg, aux

    # ---- attribute renders (kd / roughness and metallic / normals) ------------
    def render_attribute(self, cameras: Cameras, attribute: str,
                         albedo_scaling: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 4]: the attribute map premultiplied by alpha, and alpha."""
        normals = gmath.safe_normalize(self.normals)
        if attribute == "kd":
            colors = self.kd if albedo_scaling is None else self.kd * albedo_scaling
        elif attribute == "ks":
            ks = self.gaussian_ks()
            colors = torch.cat((
                torch.zeros_like(ks[:, :1]),
                ks[:, 0:1] * (1 - self.min_roughness) + self.min_roughness,
                ks[:, 1:2] * self.max_metallic,
            ), -1)
        elif attribute == "normal":
            colors = normals * 0.5 + 0.5
        else:
            raise ValueError(attribute)
        out = []
        for i in range(len(cameras)):
            cam = cameras[i]
            bend = (normals * -cam.c2w[:, 2]).sum(-1, keepdim=True) > 0
            with record_function("defer.attribute"):
                r, a, _ = self._rasterize(colors, torch.where(bend, -2.0, self.opacities), cam)
            out.append(torch.cat((r / torch.clamp(a, min=1e-6) * a, a), -1))
        return torch.stack(out)
