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
