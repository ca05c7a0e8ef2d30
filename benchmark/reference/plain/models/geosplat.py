"""GeoSplatter stage 1 — FlexiCubes -> MGAdapter Gaussians -> split-sum PBR.

Counterpart of ``geosplatting_tpu/models/geosplat.py`` on the stage-1
training path: ``tone_naive``, ``tone_aces``, ``MGAdapter``, the two
material fields (``SharedField``: one triplane trunk + MLP heads, evaluated
per face; ``GaussianField``: four hash-grid encoders, ``HashEncoding``,
evaluated per Gaussian in checkpointed chunks), ``export_ks_bundle`` and,
for stage 3, ``KsBundle`` and ``load_ks_bundle`` (``apply_ks_bundle``),
``compact_faces``, face and vertex Gaussian sampling, split-sum shading in
the fast (training) and exact (validation, export) qualities and
``GeoSplatter`` (an ``nn.Module`` that owns the stage-1 parameters) with
``get_geometry``, ``get_envmap`` and ``render``: camera by camera, or with
``batched_binning`` every camera shaded, then binned in one pass
(``bin_cameras_batched``) and composited camera by camera.

Randomness is explicit: ``render`` takes the jitter noise as a tensor (a
standard-normal draw of ``field.jitter_shape``: one row a face for the
shared field, the JAX package's ``geosplat.py:498``; a kd and a ks row a
Gaussian for the hash field, ``:443-449``) or draws it from the caller's
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import _kernels
from ..graphics import flexicubes as fc
from ..graphics import gmath
from ..graphics.cameras import Cameras
from ..graphics.mesh import TriangleMesh
from ..graphics.splats import Splats
from ..ops import cubemap as cm
from ..ops.hashgrid import HashGridConfig, hashgrid_encode
from ..ops.rasterize import camera_matrices, rasterize, rasterize_batched
from ..ops.segment_rows import gather_rows
from .encodings import TriplaneEncoding, triplane_features
from .mlp import MLP

_UP = (0.0, 0.0, 1.0)


def tone_naive(rgb: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    x = rgb * exposure
    return 1.0 - nn.functional.softplus((1.0 - x) * 100.0) / 100.0


def tone_aces(rgb: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    x = rgb * exposure
    return (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)


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
    roughness/metallic, z: raw normal offset, and with ``with_occ`` the
    stage-2 occ head: 6 raw residual-light channels), evaluated per face."""

    def __init__(self, *, resolution: int = 512, num_components: int = 32,
                 init_scale: float = 0.03, hidden: int = 64, with_occ: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.trunk = TriplaneEncoding(resolution, num_components, init_scale, **kw)
        self.kd = MLP((num_components, hidden, 3), activation="sigmoid", **kw)
        self.ks = MLP((num_components, hidden, 2), **kw)
        self.z = MLP((num_components, hidden, 1), **kw)
        # drawn after the stage-1 heads: a stage-1 field's draws are unchanged
        self.occ = MLP((num_components, hidden, 6), **kw) if with_occ else None

    def param_groups(self) -> dict[str, list[nn.Parameter]]:
        """Optimizer groups of the JAX package's ``field_group_names`` order:
        kd, ks, z, planes, then occ."""
        groups = {
            "kd": list(self.kd.parameters()),
            "ks": list(self.ks.parameters()),
            "z": list(self.z.parameters()),
            "planes": [self.trunk.planes],
        }
        if self.occ is not None:
            groups["occ"] = list(self.occ.parameters())
        return groups

    @staticmethod
    def jitter_shape(num_faces: int) -> tuple[int, ...]:
        """Shape of the face-sampling jitter noise: one point a face."""
        return (num_faces, 3)

    def apply_all(self, x: torch.Tensor, x_jitter: torch.Tensor | None = None) -> dict:
        """Every head at positions ``x`` [P, 3] in [-1, 1]. The z head sees a
        position-detached trunk evaluation."""
        feats = self.trunk(x)
        out = {
            "kd": self.kd(feats),
            "ks_raw": self.ks(feats),
            "z_raw": self.z(self.trunk(x.detach())),
        }
        if self.occ is not None:
            out["occ_raw"] = self.occ(feats)
        if x_jitter is not None:
            feats_j = self.trunk(x_jitter)
            out["kd_jitter"] = self.kd(feats_j)
            out["ks_jitter_raw"] = self.ks(feats_j)
        return out


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    """A hash grid and its bias-free MLP head (ReLU hidden layers, Kaiming-
    uniform init): the JAX package's ``HashEncoding(grid, mlp)``."""

    grid: HashGridConfig
    hidden: tuple[int, ...]
    out_dim: int
    activation: str = "none"


class HashEncoding(nn.Module):
    """Parameters ``table`` [L * T, F] and the head ``mlp`` (``w0`` ...,
    [out, in] each), the JAX package's ``{"table", "mlp"}``."""

    def __init__(self, config: HashEncodingConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.config = config
        self.table = nn.Parameter(config.grid.init(generator, device))
        self.mlp = MLP((config.grid.output_dim, *config.hidden, config.out_dim),
                       activation=config.activation, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(hashgrid_encode(self.table, x, self.config.grid))


def _default_enc(out_dim: int, activation: str, hidden: tuple[int, ...]) -> HashEncodingConfig:
    return HashEncodingConfig(
        grid=HashGridConfig(max_res=4096, log2_hashmap_size=18, grad_scaling=16.0),
        hidden=hidden, out_dim=out_dim, activation=activation,
    )


KD_ENC = _default_enc(3, "sigmoid", (32, 32))
KS_FIELD_ENC = _default_enc(2, "none", (32,))
Z_ENC = _default_enc(1, "none", (32,))


class GaussianField(nn.Module):
    """The reference's neural material field: four hash-grid encoders
    (``kd_enc`` sigmoid RGB, ``ks_enc`` raw roughness / metallic, ``z_enc``
    the raw normal offset, and with ``occ_enc`` the 6 raw residual-light
    channels), evaluated at every Gaussian's position."""

    def __init__(self, *, kd_enc: HashEncodingConfig = KD_ENC,
                 ks_enc: HashEncodingConfig = KS_FIELD_ENC, z_enc: HashEncodingConfig = Z_ENC,
                 occ_enc: HashEncodingConfig | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kd_enc = HashEncoding(kd_enc, **kw)
        self.ks_enc = HashEncoding(ks_enc, **kw)
        self.z_enc = HashEncoding(z_enc, **kw)
        self.occ_enc = HashEncoding(occ_enc, **kw) if occ_enc is not None else None

    def param_groups(self) -> dict[str, list[nn.Parameter]]:
        """Optimizer groups of the JAX package's ``field_group_names`` order:
        kd, ks, z, then occ (each an encoder's table and head)."""
        groups = {
            "kd": list(self.kd_enc.parameters()),
            "ks": list(self.ks_enc.parameters()),
            "z": list(self.z_enc.parameters()),
        }
        if self.occ_enc is not None:
            groups["occ"] = list(self.occ_enc.parameters())
        return groups

    @staticmethod
    def jitter_shape(num_faces: int) -> tuple[int, ...]:
        """Shape of the jitter noise: a kd and a ks point a Gaussian."""
        return (2, 6 * num_faces, 3)

    def apply_all(self, x: torch.Tensor) -> dict:
        """Every encoder at positions ``x`` [P, 3] in [-1, 1] (the hash
        branch of the JAX package's ``evaluate_field``); z sees ``x``
        detached."""
        out = {"kd": self.kd_enc(x), "ks_raw": self.ks_enc(x), "z_raw": self.z_enc(x.detach())}
        if self.occ_enc is not None:
            out["occ_raw"] = self.occ_enc(x)
        return out


def param_tree(module: nn.Module) -> dict:
    """A module's parameters as the JAX package's nested dict, detached."""
    out: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach()
    return out


def export_ks_bundle(field: SharedField | GaussianField) -> dict:
    """The stage-1 -> stage-2/3 roughness-predictor hand-off in the JAX
    package's layout: the trunk planes and the ks head of the shared field
    (``{"planes": [3, R, R, C], "ks": {"w0", "w1"}}``), the ks encoder of
    the hash field (``{"table": [L * T, F], "mlp": {"w0", "w1"}}``)."""
    if isinstance(field, GaussianField):
        return param_tree(field.ks_enc)
    return {
        "planes": field.trunk.planes.detach(),
        "ks": {name: p.detach() for name, p in field.ks.named_parameters()},
    }


def ks_bundle_layout(bundle) -> str | None:
    """The layout of a roughness-predictor bundle: "triplane", "hash" or
    None for neither."""
    if isinstance(bundle, dict) and "planes" in bundle:
        return "triplane"
    if isinstance(bundle, dict) and "table" in bundle and "mlp" in bundle:
        return "hash"
    return None


def check_ks_bundle(bundle) -> str:
    """``ks_bundle_layout``, raising NotImplementedError for neither."""
    layout = ks_bundle_layout(bundle)
    if layout is not None:
        return layout
    keys = sorted(bundle) if isinstance(bundle, dict) else type(bundle).__name__
    raise NotImplementedError(
        f"roughness-predictor bundle {keys}: the port reads the triplane {{planes, ks}} and "
        "the hashgrid {table, mlp} layouts only")


@torch.no_grad()
def load_ks_bundle(module: nn.Module, bundle: dict, what: str) -> None:
    """Copy a bundle of ``export_ks_bundle``'s layout (tensors or arrays)
    into ``module`` (a ``KsBundle``, a field's ``HashEncoding``), checking
    every shape."""
    for name, p in module.named_parameters():
        node = bundle
        for part in name.split("."):
            node = node[part]
        value = (node.detach() if isinstance(node, torch.Tensor)
                 else torch.from_numpy(np.array(node, dtype=np.float32)))
        value = value.to(device=p.device, dtype=torch.float32)
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{what}/{name.replace('.', '/')} has shape {tuple(value.shape)}, "
                             f"the model expects {tuple(p.shape)}")
        p.copy_(value)


class KsBundle(nn.Module):
    """Stage 3's trainable roughness predictor, the triplane branch of the
    JAX package's ``apply_ks_bundle``: ``planes`` [3, R, R, C] summed as
    the stage-1 trunk sums them, then the bias-free (-1, 64, 2) head ``ks``
    (``w0`` [64, C], ``w1`` [2, 64]), ReLU between; filled from a stage-2
    export's ``ks_enc``. Returns raw (roughness, metallic) logits."""

    def __init__(self, resolution: int, num_components: int, hidden: int = 64, device=None):
        super().__init__()
        self.planes = nn.Parameter(
            torch.zeros((3, resolution, resolution, num_components), device=device))
        self.ks = MLP((num_components, hidden, 2), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ks(triplane_features(self.planes, x))


@dataclasses.dataclass
class RenderableAttrs:
    """Per-Gaussian shading inputs."""

    kd: torch.Tensor                          # [N, 3]
    ks: torch.Tensor                          # [N, 2] (roughness, metallic) pre-remap
    normals: torch.Tensor                     # [N, 3]
    occ: torch.Tensor | None = None           # [N, 6] raw, stage 2
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


def _eval_chunked(enc: nn.Module, x: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """``enc(x)`` over rows of ``chunk`` (all at once for None), each chunk
    rematerialised in the backward: the hash-grid corner gathers would
    otherwise keep 8 rows a level and encoder alive per point."""
    parts = x.split(chunk) if chunk else (x,)
    if not torch.is_grad_enabled():
        return torch.cat([enc(p) for p in parts])
    return torch.cat([checkpoint(enc, p, use_reentrant=False) for p in parts])


def _hash_field_gaussians(field: GaussianField, splats, offsets, valid, means, *,
                          initial_guess, kd_perturb_std, ks_perturb_std, jitter_noise,
                          eval_chunk):
    """GaussianField evaluation (the JAX package's ``geosplat.py:426-470``):
    every encoder at each Gaussian's position, z at the detached position;
    the kd and ks jitter points take rows 0 and 1 of ``jitter_noise``."""
    def ev(enc, x):
        return _eval_chunked(enc, x, eval_chunk)

    offsets = offsets * torch.sigmoid(ev(field.z_enc, means.detach()))
    kd_jitter = ks_jitter = None
    if kd_perturb_std > 0 and jitter_noise is not None:
        kd_jitter = ev(field.kd_enc, torch.clamp(means + jitter_noise[0] * kd_perturb_std, -1, 1))
        if ks_perturb_std > 0:
            ks_jitter = torch.sigmoid(
                ev(field.ks_enc, torch.clamp(means + jitter_noise[1] * ks_perturb_std, -1, 1))
                + initial_guess)
    attrs = RenderableAttrs(
        kd=ev(field.kd_enc, means),
        ks=torch.sigmoid(ev(field.ks_enc, means) + initial_guess),
        normals=splats.colors,
        occ=ev(field.occ_enc, means) if field.occ_enc is not None else None,
        kd_jitter=kd_jitter,
        ks_jitter=ks_jitter,
    )
    return splats.replace(means=splats.means - offsets), attrs, offsets, valid


def get_gaussians_from_face(
    field: SharedField | GaussianField,
    mesh: TriangleMesh,
    *,
    scale: float,
    initial_guess: torch.Tensor,       # [2]
    kd_perturb_std: float = 0.0,
    ks_perturb_std: float = 0.0,
    jitter_noise: torch.Tensor | None = None,   # field.jitter_shape standard normal
    max_faces: int | None = None,
    eval_chunk: int | None = 262144,
) -> tuple[Splats, RenderableAttrs, torch.Tensor, torch.Tensor]:
    """(splats, attrs, offsets, valid). The shared field is evaluated per
    face and shared by the face's 6 Gaussians, one jitter position (std =
    kd_perturb_std, else ks_perturb_std) serving both smoothness terms; the
    hash field per Gaussian, in chunks of ``eval_chunk`` rows."""
    if max_faces is not None:
        mesh = compact_faces(mesh, max_faces)
    splats, offsets, valid = MGAdapter().make(mesh)
    if isinstance(field, GaussianField):
        return _hash_field_gaussians(
            field, splats, offsets, valid, torch.clamp(splats.means / scale, -1, 1),
            initial_guess=initial_guess, kd_perturb_std=kd_perturb_std,
            ks_perturb_std=ks_perturb_std, jitter_noise=jitter_noise, eval_chunk=eval_chunk)
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
        occ=expand(res["occ_raw"]) if "occ_raw" in res else None,
        kd_jitter=expand(res["kd_jitter"]) if "kd_jitter" in res and kd_perturb_std > 0 else None,
        ks_jitter=(
            torch.sigmoid(expand(res["ks_jitter_raw"]) + initial_guess)
            if "ks_jitter_raw" in res and ks_perturb_std > 0 else None
        ),
    )
    return splats.replace(means=splats.means - offsets), attrs, offsets, valid


def get_gaussians_from_vertex(
    field: SharedField | GaussianField,
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
        occ=heads.get("occ_raw"),
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
    env_quality: str = "fast",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-Gaussian split-sum GGX radiance. ``env_quality="fast"`` (training)
    takes the analytic FG term and the nearest environment lookup,
    ``"exact"`` the FG LUT and bilinear / trilinear lookups. Returns
    (colors [N, 3], opacities [N])."""
    if env_quality not in ("fast", "exact"):
        raise ValueError(f"env_quality: {env_quality!r}")
    fast = env_quality == "fast"
    wo = gmath.safe_normalize(camera_pos - splats.means)
    opacities = torch.sigmoid(splats.opacities[:, 0])
    roughness = attrs.ks[:, 0:1] * (1 - min_roughness) + min_roughness
    metallic = attrs.ks[:, 1:2] * max_metallic
    specular = (1.0 - metallic) * 0.04 + attrs.kd * metallic
    diffuse = attrs.kd * (1.0 - metallic)
    n_dot_v = torch.clamp((attrs.normals * wo).sum(-1, keepdim=True), min=1e-6)
    fg = cm.fg_analytic(n_dot_v, roughness) if fast else cm.sample_fg_lut(n_dot_v, roughness)
    inv_wi = 2.0 * (wo * attrs.normals).sum(-1, keepdim=True) * attrs.normals - wo
    _, l_spec = cm.sample_splitsum(
        env_base, env_mips, attrs.normals, inv_wi, roughness, with_diffuse=False,
        filter_mode="nearest" if fast else "bilinear",
        mip_filter="nearest" if fast else "trilinear",
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
    env_quality: str = "fast",
) -> tuple[torch.Tensor, dict]:
    """Split-sum shading, antialiased rasterization and naive tone mapping
    for one camera. Returns ([H, W, 4] rgba, {total_pairs, max_pairs})."""
    colors, opacities = shade_colors_splitsum(
        splats, attrs, camera.camera_pos, env_base=env_base, env_mips=env_mips,
        min_roughness=min_roughness, max_metallic=max_metallic, env_quality=env_quality,
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
    ``field`` module: a ``SharedField`` of ``triplane_*`` and
    ``field_hidden`` unless ``field`` gives one (a ``GaussianField`` on the
    same device selects the hash grid). Runs on CUDA unless ``device`` says
    otherwise."""

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
        env_quality: str = "fast",
        batched_binning: bool = False,
        triplane_resolution: int = 512,
        triplane_components: int = 32,
        field_hidden: int = 64,
        field: SharedField | GaussianField | None = None,
        generator: torch.Generator | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        device = _kernels.resolve_device(device)
        self.resolution = resolution
        self.light_resolution = light_resolution
        self.env_quality = env_quality
        self.scale = scale
        self.min_roughness = min_roughness
        self.max_metallic = max_metallic
        self.initial_guess = initial_guess
        self.smooth_type = smooth_type
        self.max_render_faces = max_render_faces
        self.pairs_per_gaussian = pairs_per_gaussian
        self.pairs_budget = pairs_budget
        self.tile_shape = tile_shape
        # bin the whole camera batch in one pass (one sort) instead of one
        # binning a camera; the images and gradients are the same
        self.batched_binning = batched_binning
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
        self.field = field if field is not None else SharedField(
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

    def get_envmap(self, method: str = "conv"):
        """(diffuse base, specular mips, white-balance regularization);
        ``method`` is the specular prefilter's ("conv" or "sampled")."""
        cubemap = self.cubemap
        white_balance_reg = gmath.abs_(cubemap - cubemap.mean(-1, keepdim=True)).mean()
        base, mips = cm.prefilter_splitsum(cubemap, method=method)
        return base, mips, white_balance_reg

    def num_field_points(self, mesh: TriangleMesh) -> int:
        """Faces of the face sampling for this mesh (``field.jitter_shape``
        of it is the jitter noise's)."""
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
        quality: str | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Returns (rgba [B, H, W, 4] tone-mapped linear, regularization,
        aux). ``jitter_noise`` is the face-sampling jitter as a standard-
        normal [F, 3] draw; without it one is drawn from ``generator``.
        ``quality="exact"`` (validation, export) takes the sampled prefilter
        and the exact split-sum lookups; ``None`` takes ``env_quality``
        ("fast" by default, what training uses)."""
        quality = quality or self.env_quality
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
                        self.field.jitter_shape(self.num_field_points(mesh)),
                        generator=generator, device=self.device,
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
            base, mips, light_reg = self.get_envmap(
                method="sampled" if quality == "exact" else "conv")
        exposure = torch.exp(self.exposure[0])

        if attrs.kd_jitter is not None:
            reg = reg + w["kd_grad"] * gmath.abs_(attrs.kd_jitter - attrs.kd).mean()
        if attrs.ks_jitter is not None:
            reg = reg + w["ks_grad"] * gmath.abs_(attrs.ks_jitter - attrs.ks).mean()
        reg = reg + light_reg * w["light"]

        shade_attrs = dataclasses.replace(attrs, kd_jitter=None, ks_jitter=None)
        if self.batched_binning:
            with record_function("geosplat.shade_rasterize"):
                rgba, total, max_pairs = self._render_batched(
                    splats, shade_attrs, cameras, exposure, base, mips, quality)
        else:
            rgba, total, max_pairs = self._render_map(
                splats, shade_attrs, cameras, exposure, base, mips, quality)
        aux = {
            "num_gaussians": valid.sum(),
            "num_surf_cubes": extracted.num_surf_cubes,
            "num_surf_edges": extracted.num_surf_edges,
            # overflow observables: silent truncation at either cap
            "num_faces_valid": num_faces_valid,
            "max_render_faces": self.max_render_faces,
            "total_pairs": total,
            "max_pairs": max_pairs,
        }
        return rgba, reg, aux

    def _render_map(self, splats, shade_attrs, cameras, exposure, base, mips, quality):
        """Shade and rasterize camera by camera: (rgba [B, H, W, 4], the
        largest total_pairs, max_pairs)."""
        rgbas, totals = [], []
        for i in range(len(cameras)):
            with record_function("geosplat.shade_rasterize"):
                rgba, pair_info = shade_splitsum(
                    splats, shade_attrs, cameras[i], exposure=exposure,
                    env_base=base, env_mips=mips,
                    min_roughness=self.min_roughness, max_metallic=self.max_metallic,
                    pairs_per_gaussian=self.pairs_per_gaussian,
                    pairs_budget=self.pairs_budget, tile_shape=self.tile_shape,
                    env_quality=quality,
                )
            rgbas.append(rgba)
            totals.append(pair_info["total_pairs"])
        return torch.stack(rgbas), torch.stack(totals).max(), pair_info["max_pairs"]

    def _render_batched(self, splats, shade_attrs, cameras, exposure, base, mips, quality):
        """Shade every camera, bin them all in one pass, composite camera by
        camera (the JAX ``batched_binning`` branch): as ``_render_map``."""
        shaded = [shade_colors_splitsum(
            splats, shade_attrs, cameras[i].camera_pos, env_base=base, env_mips=mips,
            min_roughness=self.min_roughness, max_metallic=self.max_metallic,
            env_quality=quality) for i in range(len(cameras))]
        colors_b, opac_b = (torch.stack(x) for x in zip(*shaded))
        viewmats, Ks = camera_matrices(cameras)
        render, alpha, info = rasterize_batched(
            splats.means, gmath.safe_normalize(splats.quats), torch.exp(splats.scales),
            opac_b, colors_b, viewmats, Ks, cameras.width, cameras.height,
            rasterize_mode="antialiased", pairs_per_gaussian=self.pairs_per_gaussian,
            max_pairs_override=self.pairs_budget, tile_size=self.tile_shape,
        )
        rgba = torch.cat((tone_naive(render[..., :3], exposure), alpha), -1)
        return rgba, info["total_pairs"], info["max_pairs"]
