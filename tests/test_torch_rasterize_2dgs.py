"""Port parity: the 2DGS rasterizer, GSplatter's ``2dgs`` mode and its
train step against the JAX package on the CPU.

``project_2dgs``, ``rasterize_2dgs`` (all seven outputs, and the gradients
of the five inputs and ``offset2d``), the model's ``render_rgba`` /
``render_depth`` in ``2dgs`` mode, and one ``GSplatTrainer.train_step`` with
both regularisers on (loss, PSNR, every group's gradient, the screen-space
statistic, ``reg_weights_at``). 60 Gaussians at 40x40 for the rasterizer,
300 Gaussians and 2 cameras at 32x32 for the model and the step.

Tolerances, as the JAX package's own 2DGS tests (tests/test_rasterize_2dgs.py):
outputs 2e-5 abs + 1e-4 rel; the gradients of the colour, depth, alpha and
both normal maps 5e-5 of the largest entry. The distortion's gradients 1e-3
of the largest entry: its running sums A_{i-1} = A_i - w_i cancel, so the
two packages' differently associated scans differ ~10x more there (its
forward, 1e-4 relative, shows the same). The median depth is held in value
only: it selects one pair per pixel. The step's loss rtol 1e-4 and its
gradients close_grads (1 % in L2, 2 % of the largest entry), as the 3DGS
step's test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import splats as jsplats
from geosplatting_tpu.graphics.cameras import Cameras as JCameras
from geosplatting_tpu.models.gsplatter import GSplatter as JGSplatter
from geosplatting_tpu.ops import rasterize_2dgs as j2d
from geosplatting_tpu.train.gsplat_trainer import GSplatTrainer as JTrainer
from geosplatting_tpu.train.gsplat_trainer import GSplatTrainerConfig as JConfig
from geosplatting_tpu_torch.convert import adam_from_numpy, splats_from_numpy
from geosplatting_tpu_torch.models.gsplatter import GSplatter
from geosplatting_tpu_torch.ops import rasterize_2dgs as t2d
from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

from .test_torch_geosplat import close_grads
from .test_torch_gsplat import FIELDS, adam_moments, jax_opt_state, scene
from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401

W = H = 40
OUTPUTS = ("render", "alpha", "normals", "normals_from_depth", "distort", "median_depth")
INPUTS = ("means", "quats", "scales", "opacities", "colors", "offset2d")


def disks(n_gauss=60, seed=3):
    """Seeded disks in front of an orbit camera (the JAX tests' ranges)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_gauss, 4))
    return {
        "means": rng.uniform(-0.5, 0.5, (n_gauss, 3)),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "scales": np.exp(rng.uniform(-2.5, -1.2, (n_gauss, 3))),
        "opacities": rng.uniform(0.3, 0.95, n_gauss),
        "colors": rng.uniform(0, 1, (n_gauss, 3)),
        "offset2d": np.zeros((n_gauss, 2)),
    }


def cam(w=W, h=H):
    return JCameras.from_orbit(center=jnp.zeros(3), radius=2.2, elevation_degrees=20.0,
                               num_samples=3, width=w, height=h)[0]


def weights(seed=0):
    """Cotangents of the outputs: one set for the maps, one for the
    distortion alone."""
    rng = np.random.default_rng(seed)
    maps = {"render": rng.normal(size=(H, W, 4)), "alpha": rng.normal(size=(H, W, 1)),
            "normals": rng.normal(size=(H, W, 3)),
            "normals_from_depth": rng.normal(size=(H, W, 3)),
            "distort": np.zeros((H, W, 1)), "median_depth": np.zeros((H, W, 1))}
    dist = {k: np.zeros_like(v) for k, v in maps.items()}
    dist["distort"] = rng.normal(size=(H, W, 1))
    return tuple({k: v.astype(np.float32) for k, v in w.items()} for w in (maps, dist))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX rasterizer's outputs and its gradients of both weighted sums
    (weights()), jitted once."""
    c = cam()
    x = {k: jnp.asarray(v, jnp.float32) for k, v in disks().items()}

    def raster(*a):
        outs = j2d.rasterize_2dgs(*a[:5], c.view_matrix, c.intrinsic_matrix, W, H,
                                  tile_size=16, tile_capacity=64, offset2d=a[5])
        return outs[:6], outs[6]

    def run(*args):
        outs, vjp, info = jax.vjp(raster, *args, has_aux=True)
        return (*outs, info), [vjp(tuple(jnp.asarray(w[k]) for k in OUTPUTS))
                               for w in weights()]

    return (c, *jax.jit(run)(*(x[k] for k in INPUTS)))


@pytest.mark.parametrize("tile_chunk", [4, 1])
def test_rasterize_2dgs_matches_jax(jax_run, tile_chunk):
    """All seven outputs and the gradients of all six inputs; tile_chunk 1
    cuts the tiles into more chunks, each as deep as its own fullest tile."""
    c, outs_j, grads_j = jax_run
    tc = cameras_from_jax(c)
    x = {k: t(v).requires_grad_() for k, v in disks().items()}
    outs = t2d.rasterize_2dgs(*(x[k] for k in INPUTS[:5]), tc.view_matrix, tc.intrinsic_matrix,
                              W, H, tile_size=16, tile_capacity=64, offset2d=x["offset2d"],
                              tile_chunk=tile_chunk)
    assert float(outs[1].detach().max()) > 0.9
    for name, got, want in zip(OUTPUTS, outs, outs_j):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-5, rtol=1e-4, err_msg=name)
    info, info_j = outs[6], outs_j[6]
    for k in ("means2d", "center2d", "radii", "depths"):
        np.testing.assert_allclose(n(info[k]), np.asarray(info_j[k]), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    assert int(info["total_pairs"]) == int(info_j["total_pairs"])
    assert info["max_pairs"] == info_j["max_pairs"]
    assert 0 < int(info["max_tile_pairs"]) <= info["tile_capacity"] == 64
    for wts, want, atol in zip(weights(), grads_j, (5e-5, 1e-3)):
        got = torch.autograd.grad(sum((o * t(wts[k])).sum() for k, o in zip(OUTPUTS, outs)),
                                  [x[k] for k in INPUTS], retain_graph=True)
        for name, g, g_j in zip(INPUTS, got, want):
            if name == "colors" and atol == 1e-3:
                continue   # the distortion does not read the colours
            g, g_j = n(g), np.asarray(g_j)
            scale = np.abs(g_j).max()
            assert scale > 0, name
            np.testing.assert_allclose(g / scale, g_j / scale, atol=atol, err_msg=name)


def test_project_and_depth_normals_match_jax():
    """project_2dgs column by column; the pseudo normals wrap at the image
    border (jnp.roll), so the border pixels agree too."""
    c = cam()
    tc = cameras_from_jax(c)
    x = disks(seed=5)
    args = [x[k].astype(np.float32) for k in ("means", "quats", "scales")]
    got = t2d.project_2dgs(*map(t, args), tc.view_matrix, tc.intrinsic_matrix, W, H)
    want = j2d.project_2dgs(*map(jnp.asarray, args), c.view_matrix, c.intrinsic_matrix, W, H)
    for a, b, name in zip(got, want, ("record", "center2d", "depths", "radii")):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-4, err_msg=name)
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.5, 3.0, (H, W, 1)).astype(np.float32)
    alpha = rng.uniform(0, 1, (H, W, 1)).astype(np.float32)
    pn = t2d.depth_to_camera_normals(t(depth), t(alpha), tc.intrinsic_matrix)
    pn_j = j2d.depth_to_camera_normals(jnp.asarray(depth), jnp.asarray(alpha),
                                       c.intrinsic_matrix)
    np.testing.assert_allclose(n(pn), np.asarray(pn_j), atol=2e-5, rtol=1e-4)
    assert np.abs(n(pn)[0]).sum() > 0 and np.abs(n(pn)[:, -1]).sum() > 0
    with pytest.raises(ValueError, match="render_mode"):
        t2d.rasterize_2dgs(*map(t, args), t(x["opacities"]), t(x["colors"]), tc.view_matrix,
                           tc.intrinsic_matrix, W, H, render_mode="RGBD")


def jcams():
    return JCameras.from_orbit(center=jnp.zeros(3), radius=2.5, elevation_degrees=15.0,
                               num_samples=2, width=32, height=32)


def test_model_2dgs_render_rgba_and_depth_match_jax():
    p = scene()
    c = jcams()[1]
    mj = JGSplatter(rasterize_mode="2dgs")
    mt = GSplatter(rasterize_mode="2dgs", device="cpu")
    sj = jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()})
    st = splats_from_numpy(p)
    tc = cameras_from_jax(c)
    rgba_j, info_j = jax.jit(mj.render_rgba, static_argnames="max_sh_degree")(
        sj, c, max_sh_degree=2)
    rgba_t, info_t = mt.render_rgba(st, tc, max_sh_degree=2)
    assert float(rgba_t[..., 3].max()) > 0.5
    np.testing.assert_allclose(n(rgba_t), np.asarray(rgba_j), atol=2e-5, rtol=1e-4)
    for k in ("normal", "pseudo_normal", "distort", "median_depth", "depth", "alpha_map"):
        np.testing.assert_allclose(n(info_t[k]), np.asarray(info_j[k]), atol=2e-5, rtol=1e-4,
                                   err_msg=k)
    depth_t = mt.render_depth(st, tc)
    depth_j = jax.jit(mj.render_depth)(sj, c)
    assert depth_t.shape == (32, 32, 2)
    np.testing.assert_allclose(n(depth_t), np.asarray(depth_j), atol=2e-5, rtol=1e-4)


def test_2dgs_train_step_matches_jax():
    """One step with both regularisers on, against the JAX step: loss and
    PSNR, every group's gradient (from the new first moment, which starts
    at zero), the screen-space statistic; and the schedule of the weights."""
    p = scene(sh_degree=1, seed=2)
    cams = jcams()
    gt = np.random.default_rng(7).uniform(0, 1, (2, 32, 32, 4)).astype(np.float32)
    moments = adam_moments(p, 1, mu_scale=0.0)
    reg = (5e-2 * 20, 1e-2 * 2000)   # the JAX weights, raised to move the gradients

    mj = JGSplatter(sh_degree=1, rasterize_mode="2dgs", background_color="black")
    trainer_j = JTrainer(JConfig(batch_size=2), mj, dataset_size=2)
    state = trainer_j.init_state(jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()}))
    state["opt_state"] = jax_opt_state(trainer_j, state["params"], moments)
    new_j, metrics_j = trainer_j.train_step(state, cams, jnp.asarray(gt), jax.random.key(0), 1,
                                            reg_weights=reg)
    _, metrics_j0 = trainer_j.train_step(
        trainer_j.init_state(jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()})),
        cams, jnp.asarray(gt), jax.random.key(0), 1, reg_weights=(0.0, 0.0))

    mt = GSplatter(sh_degree=1, rasterize_mode="2dgs", background_color="black", device="cpu")
    trainer_t = GSplatTrainer(GSplatTrainerConfig(batch_size=2), mt, dataset_size=2)
    trainer_t.init_state(splats_from_numpy(p))
    adam_from_numpy(trainer_t.optimizers, moments)
    metrics_t = trainer_t.train_step(cameras_from_jax(cams), t(gt), max_sh_degree=1,
                                     reg_weights=reg)

    assert int(metrics_t["nonfinite_grads"]) == 0
    assert 0 < float(metrics_t["pair_fill"]) <= 1 and 0 < float(metrics_t["tile_fill"]) <= 1
    np.testing.assert_allclose(float(metrics_t["loss"]), float(metrics_j["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics_t["psnr"]), float(metrics_j["psnr"]), atol=1e-2)
    # the regularisers are a visible part of the loss
    assert float(metrics_j["loss"]) - float(metrics_j0["loss"]) > 1e-2
    reg_t = reg[0] * float(metrics_t["normal_loss"]) + reg[1] * float(metrics_t["distort_loss"])
    np.testing.assert_allclose(reg_t, float(metrics_j["loss"]) - float(metrics_j0["loss"]),
                               rtol=1e-3)
    close_grads("xys_grad_norm", n(trainer_t.xys_grad_norm), new_j["xys_grad_norm"])
    np.testing.assert_array_equal(n(trainer_t.vis_counts), np.asarray(new_j["vis_counts"]))
    for k in FIELDS:
        grad_j = np.asarray(new_j["opt_state"][k][0].mu) / (1.0 - 0.9)
        assert np.abs(grad_j).max() > 0, k
        close_grads(f"{k} grad", n(trainer_t.params[k].grad), grad_j)

    for step in (0, 2999, 3000, 6999, 7000, 9000):
        assert trainer_t.reg_weights_at(step) == trainer_j.reg_weights_at(step)


# --- camera batching: the 2DGS render of a batch of cameras -------------------------
# The batched path bins every camera in one sort and composites each camera
# as the per-camera path does, so its tables are equal and its images and
# regularisers are the per-camera ones bit for bit on the CPU; a step's
# parameter gradients sum the cameras' terms in another order (within 1e-6
# of each gradient's largest entry). The step is held to the JAX trainer's
# ``vmap`` step with the tolerances of test_2dgs_train_step_matches_jax
# above.


def batch_inputs(num_cameras=3):
    x = {k: t(v) for k, v in disks().items()}
    cams = cameras_from_jax(JCameras.from_orbit(
        center=jnp.zeros(3), radius=2.2, elevation_degrees=20.0, num_samples=num_cameras,
        width=W, height=H))
    vm, ks = zip(*((cams[i].view_matrix, cams[i].intrinsic_matrix) for i in range(len(cams))))
    return x, torch.stack(vm), torch.stack(ks)


@pytest.mark.parametrize("width,height,tile", [(W, H, 16), (2400, 2000, 4)])
def test_bin_gaussians_batched_equals_per_camera(width, height, tile):
    """Each camera's dense table, pair total and fullest tile equal to
    ``bin_gaussians`` alone: the packed (tile, log-depth) key, and at
    300,000 tiles the (tile, float depth) fallback."""
    from geosplatting_tpu_torch.ops import rasterize as rz

    x, vm, ks = batch_inputs()
    projs = [t2d._bin_input(*t2d._project_and_shade(
        x["means"], x["quats"], x["scales"], x["colors"], vm[i], ks[i], width, height,
        near=0.01, far=1e10, sh_degree=None)[1:4], x["opacities"]) for i in range(3)]
    kw = dict(tile_size=tile, max_pairs=4096, tile_capacity=24)
    proj_b = rz.Projected(*(None if f[0] is None else torch.stack(f) for f in zip(*projs)))
    batched = rz.bin_gaussians_batched(proj_b, width, height, **kw)
    assert batched.tile_gid.shape[0] == 3
    for i, proj in enumerate(projs):
        alone = rz.bin_gaussians(proj, width, height, **kw)
        assert int(alone.total_pairs) > 0 and int(alone.max_tile_pairs) > 1
        assert torch.equal(batched.tile_gid[i], alone.tile_gid)
        assert torch.equal(batched.total_pairs[i], alone.total_pairs)
        assert torch.equal(batched.max_tile_pairs[i], alone.max_tile_pairs)


def test_rasterize_2dgs_batched_equals_per_camera():
    """All seven outputs and each camera's offset gradient equal to
    ``rasterize_2dgs`` camera by camera, with SH colours."""
    x, vm, ks = batch_inputs()
    sh = t(np.random.default_rng(4).normal(size=(60, 4, 3)) * 0.3)
    off = torch.zeros((3, 60, 2), requires_grad=True)
    outs = t2d.rasterize_2dgs_batched(x["means"], x["quats"], x["scales"], x["opacities"], sh,
                                      vm, ks, W, H, sh_degree=1, tile_capacity=64, offset2d=off)
    sum(o.sum() for o in outs[:6]).backward()
    assert tuple(outs[6]["radii"].shape) == (3, 60)
    for i in range(3):
        off_i = torch.zeros((60, 2), requires_grad=True)
        one = t2d.rasterize_2dgs(x["means"], x["quats"], x["scales"], x["opacities"], sh, vm[i],
                                 ks[i], W, H, sh_degree=1, tile_capacity=64, offset2d=off_i)
        sum(o.sum() for o in one[:6]).backward()
        for name, a, b in zip(OUTPUTS, outs, one):
            assert torch.equal(a[i], b), name
        assert torch.equal(outs[6]["radii"][i], one[6]["radii"])
        assert float(off_i.grad.abs().max()) > 0
        assert torch.equal(off.grad[i], off_i.grad)


def test_2dgs_vmap_train_step_matches_jax_and_map():
    """One step with both regularisers on and camera_batching="vmap":
    against the JAX trainer's vmap step (the tolerances of the map step's
    test above) and against the port's map step (the same losses, fills
    and densification statistics; the gradients within 1e-6 of their
    largest entry)."""
    p = scene(sh_degree=1, seed=2)
    cams = jcams()
    gt = np.random.default_rng(7).uniform(0, 1, (2, 32, 32, 4)).astype(np.float32)
    moments = adam_moments(p, 1, mu_scale=0.0)
    reg = (5e-2 * 20, 1e-2 * 2000)

    mj = JGSplatter(sh_degree=1, rasterize_mode="2dgs", background_color="black",
                    camera_batching="vmap")
    trainer_j = JTrainer(JConfig(batch_size=2), mj, dataset_size=2)
    state = trainer_j.init_state(jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()}))
    state["opt_state"] = jax_opt_state(trainer_j, state["params"], moments)
    new_j, metrics_j = trainer_j.train_step(state, cams, jnp.asarray(gt), jax.random.key(0), 1,
                                            reg_weights=reg)
    out = {}
    for batching in ("map", "vmap"):
        mt = GSplatter(sh_degree=1, rasterize_mode="2dgs", background_color="black",
                       camera_batching=batching, device="cpu")
        trainer_t = GSplatTrainer(GSplatTrainerConfig(batch_size=2), mt, dataset_size=2)
        trainer_t.init_state(splats_from_numpy(p))
        adam_from_numpy(trainer_t.optimizers, moments)
        m = trainer_t.train_step(cameras_from_jax(cams), t(gt), max_sh_degree=1,
                                 reg_weights=reg)
        out[batching] = (m, trainer_t)
    (m0, tr0), (m1, tr1) = out["map"], out["vmap"]
    assert int(m1["nonfinite_grads"]) == 0
    assert 0 < float(m1["pair_fill"]) <= 1 and 0 < float(m1["tile_fill"]) <= 1
    for k in ("loss", "psnr", "normal_loss", "distort_loss", "pair_fill", "tile_fill"):
        assert torch.equal(m1[k], m0[k]), k
    assert torch.equal(tr1.xys_grad_norm, tr0.xys_grad_norm)
    assert torch.equal(tr1.vis_counts, tr0.vis_counts)
    for k in FIELDS:
        g0, g1 = n(tr0.params[k].grad), n(tr1.params[k].grad)
        np.testing.assert_allclose(g1, g0, atol=1e-6 * np.abs(g0).max(), rtol=0, err_msg=k)

    np.testing.assert_allclose(float(m1["loss"]), float(metrics_j["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m1["psnr"]), float(metrics_j["psnr"]), atol=1e-2)
    close_grads("xys_grad_norm", n(tr1.xys_grad_norm), new_j["xys_grad_norm"])
    np.testing.assert_array_equal(n(tr1.vis_counts), np.asarray(new_j["vis_counts"]))
    for k in FIELDS:
        grad_j = np.asarray(new_j["opt_state"][k][0].mu) / (1.0 - 0.9)
        assert np.abs(grad_j).max() > 0, k
        close_grads(f"{k} grad", n(tr1.params[k].grad), grad_j)
