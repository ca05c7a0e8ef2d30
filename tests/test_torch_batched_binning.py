"""Port parity: the camera-batched rasterizer (``bin_cameras_batched``,
``composite_from_bins``, ``rasterize_batched``) at 32x32 and 2 cameras.

It is held two ways. Its binning front end against the JAX package's
``bin_cameras_batched``, jitted once for the file (the binning is plain
``jnp``; the JAX batched composite is not run): the same per-camera pair
sets, tile counts, Gaussian slot runs and ``total_pairs``, with one camera
overflowing the pair budget and the other not. And the port's batched path
against its own per-camera ("map") path in stages 1, 2 and 3 and in 3DGS:
pair lists equal exactly, images and gradients within the JAX package's own
tolerances between its two paths (tests/test_geosplat_stage1.py:129-145,
tests/test_batched_binning.py:55,67,118,130). The port projects each
camera with the map path's own shapes, so its images come out bit for bit
here; the tolerances are what the contract promises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.ops.rasterize import bin_cameras_batched as jbin_cameras_batched
from geosplatting_tpu_torch.graphics import gmath
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.graphics.splats import Splats
from geosplatting_tpu_torch.models.geosplat import GeoSplatter
from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
from geosplatting_tpu_torch.models.gsplatter import GSplatter
from geosplatting_tpu_torch.ops import rasterize as rz
from geosplatting_tpu_torch.ops import rasterize_pairs as rp
from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

from .torch_parity import n, one_torch_thread, t  # noqa: F401

W = H = 32
TILE = (16, 8)
STAGE1_TOL = dict(rgba=dict(atol=1e-5, rtol=1e-5), grad=dict(atol=2e-4, rtol=2e-3))
STAGE2_TOL = dict(rgba=dict(atol=5e-4, rtol=1e-3), grad=dict(atol=1e-3, rtol=5e-3))
STAGE3_TOL = dict(rgba=dict(atol=5e-4, rtol=1e-3), grad=dict(atol=1e-2, rtol=5e-3))


def orbit(num=2, radius=2.0, elevation=15.0):
    return Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=radius,
                              elevation_degrees=elevation, num_samples=num, width=W, height=H,
                              device="cpu")


def front_end_inputs():
    """2,000 Gaussians; camera 0 close (its pairs overflow the budget of
    4,096), camera 1 far (they do not)."""
    rng = np.random.default_rng(3)
    num = 2000
    means = rng.uniform(-0.6, 0.6, (num, 3)).astype(np.float32)
    q = rng.normal(size=(num, 4)).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-4.0, -2.5, (num, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (2, num)).astype(np.float32)
    near = JCameras.from_lookat(jnp.array([0.6, 0.5, 1.0]), jnp.zeros(3), fov_degrees=60.0,
                                width=W, height=H)
    far = JCameras.from_lookat(jnp.array([-3.0, 1.0, 3.5]), jnp.zeros(3), fov_degrees=40.0,
                               width=W, height=H)
    vm = np.stack([np.asarray(near.view_matrix), np.asarray(far.view_matrix)])
    ks = np.stack([np.asarray(near.intrinsic_matrix), np.asarray(far.intrinsic_matrix)])
    return means, quats, scales, opac, vm, ks


@pytest.fixture(scope="module")
def front_end():
    arrays = front_end_inputs()

    def bin_j(means, quats, scales, opac, vm, ks):
        return jbin_cameras_batched(means, quats, scales, opac, vm, ks, W, H,
                                    rasterize_mode="antialiased", tile_size="16x8",
                                    pairs_per_gaussian=2)

    _, bins_j, _, max_pairs_j = jax.jit(bin_j)(*(jnp.asarray(a) for a in arrays))
    proj_t, bins_t, max_pairs_t = rz.bin_cameras_batched(
        *(t(a) for a in arrays), W, H, rasterize_mode="antialiased", tile_size=TILE,
        pairs_per_gaussian=2)
    assert max_pairs_t == int(max_pairs_j) == 4096
    return arrays, jax.device_get(bins_j), proj_t, bins_t


def test_front_end_matches_jax(front_end):
    """Per camera: the JAX vmapped binning's pair totals, slot runs, tile
    counts and per-tile pair multisets (lax.sort is not stable)."""
    _, bins_j, _, bins_t = front_end
    totals = n(bins_t.total_pairs)
    np.testing.assert_array_equal(totals, np.asarray(bins_j.total_pairs))
    assert totals[0] > 4096 >= totals[1]       # one camera overflows, one does not
    for c in range(2):
        for field in ("gs_count", "gs_start", "gs_inv"):
            np.testing.assert_array_equal(n(getattr(bins_t, field)[c]),
                                          np.asarray(getattr(bins_j, field)[c]), err_msg=field)
        counts = np.asarray(bins_j.tile_counts[c])
        seg = n(bins_t.seg_start[c])
        np.testing.assert_array_equal(np.diff(seg), counts)
        gid_j, gid_t = np.asarray(bins_j.sorted_gid[c]), n(bins_t.sorted_gid[c])
        start = 0
        for tile, cnt in enumerate(counts):
            assert sorted(gid_j[start:start + cnt]) == sorted(gid_t[seg[tile]:seg[tile + 1]])
            start += cnt


def test_front_end_matches_per_camera_binning(front_end):
    """Each camera's slice of the one batched sort is ``bin_pairs`` of that
    camera alone, field for field: the overflowing camera's depth-priority
    order does not reach the other's."""
    arrays, _, proj_t, bins_t = front_end
    for c in range(2):
        alone = rp.bin_pairs(rp.camera_slice(proj_t, c), W, H, tile_size=TILE, max_pairs=4096)
        for field, got in zip(rp.PairBins._fields, rp.camera_slice(bins_t, c)):
            assert torch.equal(got, getattr(alone, field)), field


def flat_grads(module) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel())
                      for p in module.parameters()])


def map_vs_batched(make, render, tol):
    """Render and differentiate sum(rgba) + reg with the map and the batched
    model from the same weights and draws; compare."""
    out = {}
    for batched in (False, True):
        model = make(batched)
        rgba, reg, aux = render(model)
        (rgba.sum() + reg).backward()
        out[batched] = (rgba.detach(), aux, flat_grads(model))
    (rgba0, aux0, g0), (rgba1, aux1, g1) = out[False], out[True]
    assert int(aux0["total_pairs"]) == int(aux1["total_pairs"]) > 0
    torch.testing.assert_close(rgba1, rgba0, **tol["rgba"])
    assert bool(torch.isfinite(g1).all()) and float(g1.abs().max()) > 0
    torch.testing.assert_close(g1, g0, **tol["grad"])
    return rgba1


def record_bins(monkeypatch):
    """Collect the per-camera PairBins each path composites."""
    seen = []
    composite = rp.composite_pairs

    def spy(bins, *args):
        seen.append(bins)
        return composite(bins, *args)

    monkeypatch.setattr(rz, "composite_pairs", spy)
    return seen


def test_stage1_batched_matches_map(monkeypatch):
    seen = record_bins(monkeypatch)
    cams = orbit(elevation=10.0)

    def make(batched):
        g = torch.Generator().manual_seed(0)
        m = GeoSplatter(resolution=10, light_resolution=16, scale=1.0, triplane_resolution=32,
                        max_render_faces=1024, pairs_per_gaussian=4, tile_shape="16x8",
                        batched_binning=batched, generator=g, device="cpu")
        with torch.no_grad():
            m.sdf.copy_(torch.linalg.norm(m.grid.base_vertices("cpu") - 0.03, dim=-1) - 0.45)
            m.deform.normal_(0.0, 0.1, generator=g)
            m.weights.normal_(0.0, 0.1, generator=g)
        return m

    noise = torch.randn((1024, 3), generator=torch.Generator().manual_seed(1))
    map_vs_batched(make, lambda m: m.render(cams, jitter_noise=noise), STAGE1_TOL)
    # the forward's two cameras on each path: pair lists equal exactly
    assert len(seen) == 4
    for a, b in zip(seen[:2], seen[2:]):
        assert torch.equal(a.sorted_gid, b.sorted_gid) and torch.equal(a.seg_start, b.seg_start)


def test_stage2_batched_matches_map():
    cams = orbit()

    def make(batched):
        g = torch.Generator().manual_seed(0)
        m = GeoSplatterMC(resolution=10, scale=1.0, num_samples_x=2, shadow_steps=4,
                          max_render_faces=1024, triplane_resolution=32, pairs_per_gaussian=4,
                          batched_binning=batched, generator=g, device="cpu")
        with torch.no_grad():
            m.sdf.copy_(torch.linalg.norm(m.grid.base_vertices("cpu") - 0.03, dim=-1) - 0.45)
            m.deform.normal_(0.0, 0.1, generator=g)
            m.weights.normal_(0.0, 0.1, generator=g)
        return m

    g = torch.Generator().manual_seed(2)
    probe = make(False)
    noise = torch.randn(probe.field.jitter_shape(probe.num_field_points()), generator=g)
    draws = [probe.draw_shade(g) for _ in range(2)]
    map_vs_batched(make, lambda m: m.render(cams, jitter_noise=noise, draws=draws), STAGE2_TOL)


def stage3_model(batched):
    """The JAX stage-3 test's export (tests/test_batched_binning.py:80-102),
    drawn with numpy."""
    rng = np.random.default_rng(0)
    num = 64
    means = rng.uniform(-0.4, 0.4, (num, 3)).astype(np.float32)
    m = GeoSplatterDefer(num_gaussians=num, ks_resolution=16, resolution=10, scale=1.0,
                         num_samples_x=2, mesh_tile_capacity=32, pairs_per_gaussian=4,
                         batched_binning=batched, device="cpu")
    q = rng.normal(size=(num, 4)).astype(np.float32)
    values = {"means": means, "scales": np.full((num, 3), -2.5),
              "opacities": np.full((num, 1), 2.0),
              "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
              "normals": means / np.linalg.norm(means, axis=-1, keepdims=True),
              "kd": rng.uniform(0.2, 0.8, (num, 3)), "occ": rng.normal(size=(num, 6)) * 0.1}
    with torch.no_grad():
        for k, v in values.items():
            getattr(m, k).copy_(t(v))
        m.latlng_hue.fill_(0.45)
        m.latlng_value.fill_(0.6)
        for p in m.ks_enc.parameters():
            p.copy_(t(rng.normal(size=p.shape) * 0.1))
    grid_pts = rng.uniform(size=(11 ** 3, 3))
    m.set_geometry({"mesh_v": rng.uniform(-0.4, 0.4, (16, 3)).astype(np.float32),
                    "mesh_i": rng.integers(0, 16, (20, 3)), "mesh_mask": np.ones(20, bool),
                    "sdf": (np.linalg.norm(grid_pts - 0.5, axis=-1) - 0.3).astype(np.float32),
                    "initial_guess": np.array([-3.0, -3.0], np.float32)})
    return m


def test_stage3_batched_matches_map():
    """The per-camera kill of back-facing Gaussians (opacity logit -2)
    feeds the batched binning."""
    cams = orbit()
    g = torch.Generator().manual_seed(2)
    draws = [stage3_model(False).draw_shade(cams, g) for _ in range(2)]
    map_vs_batched(stage3_model, lambda m: m.render(cams, draws=draws), STAGE3_TOL)


def gsplat_scene(num=300):
    rng = np.random.default_rng(5)
    return Splats(
        means=t(rng.uniform(-0.6, 0.6, (num, 3))),
        scales=t(rng.uniform(-4.0, -2.5, (num, 3))),
        quats=t(rng.normal(size=(num, 4))),
        colors=t(rng.uniform(0.0, 1.0, (num, 3))),
        opacities=t(rng.uniform(-1.0, 2.0, (num, 1))),
        shs=t(rng.normal(size=(num, 15, 3)) * 0.1),
    )


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_gsplat_vmap_matches_map(mode):
    """One 3DGS train step camera-batched and camera by camera: images, the
    densification statistics (``xys_grad_norm`` from the [B, N, 2] hook,
    ``vis_counts`` from each camera's radii) and the updated Gaussians."""
    cams = orbit(radius=2.2)
    gt = torch.rand((2, H, W, 4), generator=torch.Generator().manual_seed(4))
    out = {}
    for batching in ("map", "vmap"):
        model = GSplatter(rasterize_mode=mode, camera_batching=batching, device="cpu")
        trainer = GSplatTrainer(GSplatTrainerConfig(), model, dataset_size=2)
        trainer.init_state(gsplat_scene())
        m = trainer.train_step(cams, gt, max_sh_degree=3, background=torch.full((3,), 0.3))
        rgba, _ = model.render_rgba_batched(trainer.splats(), cams, max_sh_degree=3) \
            if batching == "vmap" else (torch.stack(
                [model.render_rgba(trainer.splats(), cams[i], max_sh_degree=3)[0]
                 for i in range(2)]), None)
        out[batching] = (m, trainer.xys_grad_norm.clone(), trainer.vis_counts.clone(),
                         rgba.detach(), trainer.splats().means.detach().clone())
    (m0, xy0, vis0, img0, means0), (m1, xy1, vis1, img1, means1) = out["map"], out["vmap"]
    assert float(vis1.sum()) > 0 and float(xy1.max()) > 0
    torch.testing.assert_close(vis1, vis0, atol=0, rtol=0)
    torch.testing.assert_close(xy1, xy0, **STAGE1_TOL["grad"])
    torch.testing.assert_close(m1["loss"], m0["loss"], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(img1, img0, **STAGE1_TOL["rgba"])
    torch.testing.assert_close(means1, means0, atol=1e-6, rtol=1e-6)


def test_rasterize_batched_matches_rasterize():
    """``rasterize_batched`` image by image against ``rasterize``, with
    per-camera opacities and colours and the [B, N, 2] offset hook's
    gradient."""
    rng = np.random.default_rng(7)
    num = 400
    means = t(rng.uniform(-0.6, 0.6, (num, 3)))
    quats = gmath.safe_normalize(t(rng.normal(size=(num, 4))))
    scales = torch.exp(t(rng.uniform(-4.0, -2.0, (num, 3))))
    opac = t(rng.uniform(0.2, 0.95, (2, num)))
    colors = t(rng.uniform(size=(2, num, 3)))
    cams = orbit()
    vm, ks = rz.camera_matrices(cams)
    off = torch.zeros((2, num, 2), requires_grad=True)
    render, alpha, info = rz.rasterize_batched(
        means, quats, scales, opac, colors, vm, ks, W, H, tile_size=TILE, means2d_offset=off)
    render.sum().backward()
    for i in range(2):
        off_i = torch.zeros((num, 2), requires_grad=True)
        r, a, info_i = rz.rasterize(means, quats, scales, opac[i], colors[i], vm[i], ks[i], W, H,
                                    tile_size=TILE, means2d_offset=off_i,
                                    rasterize_mode="antialiased")
        r.sum().backward()
        assert torch.equal(render[i], r) and torch.equal(alpha[i], a)
        assert torch.equal(info["radii"][i], info_i["radii"])
        torch.testing.assert_close(off.grad[i], off_i.grad, atol=1e-6, rtol=1e-6)
    assert float(alpha.max()) > 0.5 and float(off.grad.abs().max()) > 0
