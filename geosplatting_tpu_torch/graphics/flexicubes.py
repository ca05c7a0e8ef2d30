"""FlexiCubes — differentiable dual-marching-cubes isosurface extraction.

Counterpart of ``geosplatting_tpu/graphics/flexicubes.py`` (``make_grid``,
``extract``, ``sdf_entropy``). It keeps the padded static budgets
(``max_surf_cubes`` / ``max_surf_edges``) and the ascending order of
``nonzero(size=...)``, so the mesh buffers line up with the JAX package's
index for index and everything downstream (face compaction, Gaussian counts,
the rasterizer's pair budget) has the same shapes and meaning.

The 256-case edge-group tables are derived from marching tetrahedra over
the Kuhn 6-tet decomposition of the cube (this module's own copy of the
derivation; nothing is transcribed).
"""
from __future__ import annotations

import functools
from itertools import permutations
from typing import NamedTuple

import numpy as np
import torch

from ..ops.segment_rows import gather_rows
from .gmath import abs_
from .mesh import TriangleMesh

# corner index c has coords (c & 1, (c >> 1) & 1, (c >> 2) & 1)
CUBE_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)
# 12 canonical edges: 4 per axis direction, (base corner, base | bit(dir))
EDGE_CA = np.array([0, 2, 4, 6, 0, 1, 4, 5, 0, 1, 2, 3], np.int64)
EDGE_DIR = np.array([0] * 4 + [1] * 4 + [2] * 4, np.int64)
EDGE_CB = EDGE_CA | (1 << EDGE_DIR)


@functools.lru_cache(maxsize=1)
def _build_dmc_tables() -> tuple[np.ndarray, np.ndarray, int, int]:
    """(dmc_table [256, MAX_VD, MAX_E] local-edge ids padded with -1,
    num_vd [256], MAX_VD, MAX_E): connected components of the marching-
    tetrahedra crossings of each case define its dual-vertex edge groups."""
    tets = [
        (0, 1 << p0, (1 << p0) | (1 << p1), 7)
        for (p0, p1, _p2) in permutations(range(3))
    ]
    edge_of_pair = {
        frozenset((int(a), int(b))): e
        for e, (a, b) in enumerate(zip(EDGE_CA, EDGE_CB))
    }

    groups_all: list[list[list[int]]] = []
    for case in range(256):
        occ = [(case >> i) & 1 for i in range(8)]
        parent: dict[frozenset, frozenset] = {}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(nodes):
            for n in nodes:
                parent.setdefault(n, n)
            roots = [find(n) for n in nodes]
            for r in roots[1:]:
                parent[r] = roots[0]

        for tet in tets:
            inside = [v for v in tet if occ[v]]
            k = len(inside)
            if k in (0, 4):
                continue
            if k in (1, 3):
                v = inside[0] if k == 1 else [u for u in tet if not occ[u]][0]
                union([frozenset((v, u)) for u in tet if u != v])
            else:
                a, b = inside
                c, d = [u for u in tet if not occ[u]]
                union([
                    frozenset((a, c)), frozenset((a, d)),
                    frozenset((b, c)), frozenset((b, d)),
                ])

        comps: dict[frozenset, list] = {}
        for n in parent:
            comps.setdefault(find(n), []).append(n)
        groups = []
        for nodes in comps.values():
            edges = sorted(edge_of_pair[n] for n in nodes if n in edge_of_pair)
            if edges:
                groups.append(edges)
        flat = sorted(e for g in groups for e in g)
        expect = [e for e in range(12) if occ[int(EDGE_CA[e])] != occ[int(EDGE_CB[e])]]
        if flat != expect:
            raise AssertionError(f"inconsistent DMC case {case}: {groups} vs {expect}")
        groups_all.append(sorted(groups))

    max_vd = max(len(g) for g in groups_all)
    max_e = max((len(e) for g in groups_all for e in g), default=1)
    table = np.full((256, max_vd, max_e), -1, np.int64)
    num_vd = np.zeros((256,), np.int64)
    for case, groups in enumerate(groups_all):
        num_vd[case] = len(groups)
        for i, g in enumerate(groups):
            table[case, i, : len(g)] = g
    return table, num_vd, max_vd, max_e


@functools.lru_cache(maxsize=1)
def _build_local_edge_slot() -> np.ndarray:
    """[3, 2, 2] -> local edge index: for an edge in direction d, the cube at
    perpendicular offsets (o1, o2) in {-1,0}^2 sees it as this local edge."""
    edge_of = {(int(EDGE_CA[e]), int(EDGE_DIR[e])): e for e in range(12)}
    out = np.zeros((3, 2, 2), np.int64)
    for d in range(3):
        p1, p2 = [p for p in range(3) if p != d]
        for i1, o1 in enumerate((-1, 0)):
            for i2, o2 in enumerate((-1, 0)):
                coords = [0, 0, 0]
                coords[p1] = -o1
                coords[p2] = -o2
                corner = coords[0] | (coords[1] << 1) | (coords[2] << 2)
                out[d, i1, i2] = edge_of[(corner, d)]
    return out


class FlexiCubesGrid(NamedTuple):
    resolution: tuple[int, int, int]
    scale: float
    max_surf_cubes: int
    max_surf_edges: int

    @property
    def num_vertices(self) -> int:
        rx, ry, rz = self.resolution
        return (rx + 1) * (ry + 1) * (rz + 1)

    @property
    def num_cubes(self) -> int:
        rx, ry, rz = self.resolution
        return rx * ry * rz

    def base_vertices(self, device=None) -> torch.Tensor:
        """[V, 3] undeformed grid vertex positions in [-scale, scale]^3."""
        rx, ry, rz = self.resolution
        idx = np.arange(self.num_vertices)
        x = idx % (rx + 1)
        y = (idx // (rx + 1)) % (ry + 1)
        z = idx // ((rx + 1) * (ry + 1))
        v = np.stack((x / rx, y / ry, z / rz), -1).astype(np.float32)
        return torch.as_tensor((2 * v - 1) * np.float32(self.scale), device=device)

    def deform_step(self) -> float:
        return 0.5 * self.scale / max(self.resolution)


def make_grid(
    resolution: int | tuple[int, int, int],
    *,
    scale: float = 1.0,
    surf_cube_budget: float = 8.0,
    surf_edge_budget: float = 16.0,
) -> FlexiCubesGrid:
    res = (resolution,) * 3 if isinstance(resolution, int) else tuple(resolution)
    r2 = max(res) ** 2
    return FlexiCubesGrid(
        resolution=res,
        scale=scale,
        max_surf_cubes=min(int(surf_cube_budget * r2), int(np.prod(res))),
        max_surf_edges=int(surf_edge_budget * r2),
    )


class ExtractedMesh(NamedTuple):
    mesh: TriangleMesh            # padded: [4*S+E, 3] verts, [4*E, 3] faces + mask
    l_dev: torch.Tensor           # [] masked mean of the per-edge-group deviation
    num_surf_cubes: torch.Tensor  # [] actual count (budget-overflow check)
    num_surf_edges: torch.Tensor  # [] actual count




def _vertex_id(grid: FlexiCubesGrid, x, y, z):
    rx, ry, _ = grid.resolution
    return (z * (ry + 1) + y) * (rx + 1) + x


def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]``: the first
    ``size`` indices where ``mask`` is set, ascending, padded with ``fill``.
    Sync-free (no data-dependent shape)."""
    pos = torch.cumsum(mask.long(), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.long, device=mask.device)
    src = torch.arange(mask.shape[0], device=mask.device)
    out.scatter_(0, tgt, src)
    return out[:size]


def _compact_lookup(keys: torch.Tensor, valid: torch.Tensor, size: int, fill: int):
    """[size + 1] table with table[keys[i]] = i where valid, else ``fill``."""
    table = torch.full((size + 1,), fill, dtype=torch.long, device=keys.device)
    tgt = torch.where(valid, keys, size)
    table.scatter_(0, tgt, torch.arange(keys.shape[0], device=keys.device))
    table[size] = fill
    return table


def extract(
    grid: FlexiCubesGrid,
    sdf: torch.Tensor,                    # [V]
    deform: torch.Tensor | None = None,   # [V, 3] raw (tanh'ed here)
    alpha: torch.Tensor | None = None,    # [F, 8] raw
    beta: torch.Tensor | None = None,     # [F, 12] raw
    gamma: torch.Tensor | None = None,    # [F, 1] raw
    *,
    weight_scale: float = 0.99,
    sdf_eps: float | None = None,
) -> ExtractedMesh:
    """Differentiable dual marching cubes (flexicubes.py:207). Each weight
    left out is 1 (the undeformed grid without ``deform``); the raw weights
    map into 1 +- ``weight_scale`` (gamma into (1 - ws) / 2 + (0, ws)).
    ``sdf_eps`` pulls every zero crossing's lerp weight w to (1 - eps) w +
    eps / 2."""
    dmc_table_np, _num_vd_np, MAX_VD, _MAX_E = _build_dmc_tables()
    local_slot_np = _build_local_edge_slot()
    dev = sdf.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rx, ry, rz = grid.resolution
    V = grid.num_vertices
    F = grid.num_cubes
    S = grid.max_surf_cubes
    E = grid.max_surf_edges

    vertices = grid.base_vertices(dev)
    if deform is not None:
        vertices = vertices + torch.tanh(deform) * grid.deform_step()
    sdf = sdf.reshape(V)
    occ = sdf < 0

    # --- per-cube corner ids and case ids ------------------------------------
    cidx = torch.arange(F, device=dev)
    cx = cidx % rx
    cy = (cidx // rx) % ry
    cz = cidx // (rx * ry)
    corners = t(CUBE_CORNERS)
    corner_vid = _vertex_id(
        grid,
        cx[:, None] + corners[None, :, 0],
        cy[:, None] + corners[None, :, 1],
        cz[:, None] + corners[None, :, 2],
    )  # [F, 8]
    cocc = occ[corner_vid]
    case_ids = (cocc.long() * (1 << torch.arange(8, device=dev))[None, :]).sum(1)
    occ_sum = cocc.sum(1)
    surf_mask = (occ_sum > 0) & (occ_sum < 8)
    num_surf_cubes = surf_mask.sum()

    sc = nonzero_padded(surf_mask, S, F)
    sc_valid = sc < F
    sc_safe = sc.clamp(max=F - 1)
    case_s = torch.where(sc_valid, case_ids[sc_safe], 0)

    ws = weight_scale
    ones = sdf.new_ones
    alpha_s = (torch.tanh(gather_rows(alpha, sc_safe)) * ws + 1.0 if alpha is not None
               else ones((S, 8)))
    beta_s = (torch.tanh(gather_rows(beta, sc_safe)) * ws + 1.0 if beta is not None
              else ones((S, 12)))
    gamma_s = (torch.sigmoid(gather_rows(gamma, sc_safe)[:, 0]) * ws + (1 - ws) / 2
               if gamma is not None else ones((S,)))

    # --- surface edges (analytic ids: d * V + base vertex, then compaction) --
    strides = t([1, rx + 1, (rx + 1) * (ry + 1)])
    vidx = torch.arange(V, device=dev)
    vx = vidx % (rx + 1)
    vy = (vidx // (rx + 1)) % (ry + 1)
    vz = vidx // ((rx + 1) * (ry + 1))
    in_bounds = torch.stack((vx < rx, vy < ry, vz < rz), 0)        # [3, V]
    other = (vidx[None, :] + strides[:, None]).clamp(max=V - 1)    # [3, V]
    edge_surf = (in_bounds & (occ[None, :] != occ[other])).reshape(-1)
    num_surf_edges = edge_surf.sum()

    se = nonzero_padded(edge_surf, E, 3 * V)
    se_valid = se < 3 * V
    se_safe = se.clamp(max=3 * V - 1)
    edge_compact = _compact_lookup(se, se_valid, 3 * V, E)

    se_dir = se_safe // V
    se_a = se_safe % V
    se_b = (se_a + strides[se_dir]).clamp(max=V - 1)
    sa = gather_rows(sdf, se_a)
    sb = gather_rows(sdf, se_b)

    def lerp(sa, sb, xa, xb):
        denom = sa - sb
        denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
        w_b = sa / denom
        if sdf_eps is not None:
            w_b = (1 - sdf_eps) * w_b + sdf_eps / 2
        return xb * w_b[..., None] + xa * (1 - w_b)[..., None]

    zero_x = lerp(sa, sb, gather_rows(vertices, se_a), gather_rows(vertices, se_b))  # [E, 3]

    # --- dual vertices: [S, MAX_VD, MAX_E] over every surface cube ------------
    dmc = t(dmc_table_np)[case_s]                                   # [S, VD, K]
    entry_valid = (dmc >= 0) & sc_valid[:, None, None]
    e_local = dmc.clamp(min=0)
    ca = t(EDGE_CA)[e_local]
    ed = t(EDGE_DIR)[e_local]
    cc = corners[ca]                                                # [S, VD, K, 3]
    base_vid = _vertex_id(
        grid,
        cx[sc_safe][:, None, None] + cc[..., 0],
        cy[sc_safe][:, None, None] + cc[..., 1],
        cz[sc_safe][:, None, None] + cc[..., 2],
    )
    geid = ed * V + base_vid
    ceid = edge_compact[torch.where(entry_valid, geid, 3 * V)]
    ceid_safe = ceid.clamp(max=E - 1)

    alpha_rep = alpha_s[:, None, :].expand(S, MAX_VD, 8)
    a_of = torch.gather(alpha_rep, 2, t(EDGE_CA)[e_local])
    b_of = torch.gather(alpha_rep, 2, t(EDGE_CB)[e_local])
    sa_g = gather_rows(sa, ceid_safe) * a_of
    sb_g = gather_rows(sb, ceid_safe) * b_of
    xa_g = gather_rows(vertices, se_a[ceid_safe])
    xb_g = gather_rows(vertices, se_b[ceid_safe])
    ue = lerp(sa_g, sb_g, xa_g, xb_g)                                # [S, VD, K, 3]
    ue = torch.where(entry_valid[..., None], ue, 0.0)

    bw = torch.gather(beta_s[:, None, :].expand(S, MAX_VD, 12), 2, e_local)
    bw = torch.where(entry_valid, bw, 0.0)
    bw_sum = bw.sum(-1, keepdim=True).clamp(min=1e-12)              # [S, VD, 1]
    vd = (ue * bw[..., None]).sum(-2) / bw_sum                      # [S, VD, 3]

    # L_dev: mean absolute deviation of per-edge crossings from their dual vertex
    zc_g = gather_rows(zero_x, ceid_safe)
    diff = zc_g - vd[:, :, None, :]
    dist = torch.sqrt((diff * diff).sum(-1) + 1e-20)
    cnt = entry_valid.sum(-1).clamp(min=1)
    mean_l2 = torch.where(entry_valid, dist, 0.0).sum(-1) / cnt
    mad = torch.where(entry_valid, abs_(dist - mean_l2[..., None]), 0.0)
    l_dev = mad.sum() / entry_valid.sum().clamp(min=1)

    # (cube, local edge) -> vd slot, -1 where no vd uses the edge
    slot1 = (torch.arange(MAX_VD, device=dev) + 1)[None, :, None].expand_as(e_local)
    vd_slot_of_edge = torch.zeros((S, 13), dtype=torch.long, device=dev).scatter_reduce(
        1, torch.where(entry_valid, e_local, 12).reshape(S, -1),
        slot1.reshape(S, -1), reduce="amax",
    )[:, :12] - 1

    # --- quads: one per interior surface edge (analytic 4-cube adjacency) -----
    coords = torch.stack((vx[se_a], vy[se_a], vz[se_a]), -1)        # [E, 3]
    perp = t([[1, 2], [0, 2], [0, 1]])[se_dir]                      # [E, 2]
    offs = t([[-1, -1], [0, -1], [-1, 0], [0, 0]])                  # [4, 2]
    eye3 = torch.eye(3, dtype=torch.long, device=dev)
    delta = (
        eye3[perp[:, 0]][:, None, :] * offs[None, :, 0, None]
        + eye3[perp[:, 1]][:, None, :] * offs[None, :, 1, None]
    )                                                               # [E, 4, 3]
    ccoords = coords[:, None, :] + delta
    res_arr = t([rx, ry, rz])
    cube_ok = ((ccoords >= 0) & (ccoords < res_arr)).all(-1)
    quad_ok = cube_ok.all(-1) & se_valid
    ccoords_c = torch.minimum(ccoords.clamp(min=0), res_arr - 1)
    clin = (ccoords_c[..., 2] * ry + ccoords_c[..., 1]) * rx + ccoords_c[..., 0]

    cube_compact = _compact_lookup(sc, sc_valid, F, S)
    qcube = cube_compact[torch.where(quad_ok[:, None], clin, F)]    # [E, 4]
    quad_ok = quad_ok & (qcube < S).all(-1)
    qcube_safe = qcube.clamp(max=S - 1)

    lslot = t(local_slot_np)
    le = lslot[se_dir[:, None], offs[None, :, 0] + 1, offs[None, :, 1] + 1]  # [E, 4]
    vslot = vd_slot_of_edge[qcube_safe, le]
    quad_ok = quad_ok & (vslot >= 0).all(-1)
    qvd = qcube_safe * MAX_VD + vslot.clamp(min=0)

    # winding: face normal points to the positive-SDF side
    fwd = (sa < 0) ^ (se_dir == 1)
    z_idx = t([[0, 1, 3, 2], [2, 3, 1, 0]])
    cyc = z_idx[torch.where(fwd, 0, 1)]
    quad = torch.gather(qvd, 1, cyc)                                # [E, 4]

    # gamma-weighted center
    vd_flat = vd.reshape(S * MAX_VD, 3)
    gam_flat = gamma_s.repeat_interleave(MAX_VD)
    qv = gather_rows(vd_flat, quad)
    qg = gather_rows(gam_flat, quad)
    g02 = qg[:, 0] * qg[:, 2]
    g13 = qg[:, 1] * qg[:, 3]
    v02 = 0.5 * (qv[:, 0] + qv[:, 2])
    v13 = 0.5 * (qv[:, 1] + qv[:, 3])
    center = (v02 * g02[:, None] + v13 * g13[:, None]) / (g02 + g13 + 1e-8)[:, None]

    all_verts = torch.cat((vd_flat, center), 0)
    center_idx = S * MAX_VD + torch.arange(E, device=dev)
    quad_roll = torch.roll(quad, -1, dims=1)
    faces = torch.stack(
        (quad, quad_roll, center_idx[:, None].expand(E, 4)), -1
    ).reshape(E * 4, 3)
    face_mask = quad_ok.repeat_interleave(4)
    faces = torch.where(face_mask[:, None], faces, 0)

    return ExtractedMesh(
        mesh=TriangleMesh(vertices=all_verts, indices=faces, face_mask=face_mask),
        l_dev=l_dev,
        num_surf_cubes=num_surf_cubes,
        num_surf_edges=num_surf_edges,
    )


def sdf_entropy(grid: FlexiCubesGrid, sdf: torch.Tensor) -> torch.Tensor:
    """BCE consistency of SDF logits across sign-change edges."""
    rx, ry, rz = grid.resolution
    V = grid.num_vertices
    sdf = sdf.reshape(V)
    occ = sdf < 0
    vidx = torch.arange(V, device=sdf.device)
    vx = vidx % (rx + 1)
    vy = (vidx // (rx + 1)) % (ry + 1)
    vz = vidx // ((rx + 1) * (ry + 1))
    in_bounds = torch.stack((vx < rx, vy < ry, vz < rz), 0)

    def shift(s):
        return torch.cat([sdf[s:], sdf[-1:].expand(s)])

    sb = torch.stack([shift(s) for s in (1, rx + 1, (rx + 1) * (ry + 1))])
    change = in_bounds & (occ[None, :] != (sb < 0))
    sa = sdf[None, :].expand(3, V)

    def bce_logits(x, tgt):
        # ties at x == 0 take jnp's gradients (grid SDFs such as |v| - r hit
        # exactly 0 on grid vertices): torch.maximum splits like jnp.maximum
        return torch.maximum(x, torch.zeros_like(x)) - x * tgt + torch.log1p(torch.exp(-abs_(x)))

    per = bce_logits(sa, (sb > 0).to(sdf.dtype)) + bce_logits(sb, (sa > 0).to(sdf.dtype))
    cnt = change.sum().clamp(min=1)
    return torch.where(change, per, 0.0).sum() / cnt
