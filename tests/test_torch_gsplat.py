"""Port parity: vanilla 3DGS against the JAX package on the CPU.

SH evaluation, the rasterizer with ``sh_degree``, ``GSplatter`` in both
ported modes, one ``GSplatTrainer.train_step`` (loss, updated parameters and
the densification statistics), ``split`` / ``densify_and_cull`` / ``cull``,
``mutate_params`` and ``Splats.random``. 300 Gaussians, 2 cameras at 32x32.
JAX renders through its CPU reference rasterizer (backend "auto" on the
CPU), the port through its kernels' plain versions; the random draws come
from jax.random and are handed to both.

Tolerances: SH values rtol 1e-6, their gradients rtol 1e-5; images atol
1e-3 (transmittance-cutoff flips, tests/test_rasterize_pallas.py:53); the
rasterizer's gradients and the screen-space gradient statistics 1 % in L2
and 2 % of the largest entry (close_grads), as the stage-1 tests; the loss
rtol 1e-4; every group's gradient close_grads against the JAX one (read
from its new first moment, which starts at zero); the updated parameters
within 2 % of the update's largest entry (their Adam state starts from the
same moments, fed to both through ``convert``, so the update is smooth in
the gradient); densification and the optimizer surgery exactly, and the
knn scales rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geosplatting_tpu.graphics import gmath as jgmath
from geosplatting_tpu.graphics import splats as jsplats
from geosplatting_tpu.models.gsplatter import GSplatter as JGSplatter
from geosplatting_tpu.ops.rasterize import rasterize as jrasterize
from geosplatting_tpu.train.gsplat_trainer import GSplatTrainer as JTrainer
from geosplatting_tpu.train.gsplat_trainer import GSplatTrainerConfig as JConfig
from geosplatting_tpu.train.optim import mutate_optax_state
from geosplatting_tpu_torch.convert import (
    adam_from_numpy, adam_to_numpy, splats_from_numpy, splats_to_numpy,
)
from geosplatting_tpu_torch.graphics import gmath
from geosplatting_tpu_torch.graphics import splats as tsplats
from geosplatting_tpu_torch.models.gsplatter import GSplatter
from geosplatting_tpu_torch.ops.rasterize import rasterize
from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

from .test_torch_geosplat import close_grads
from .torch_parity import cameras_from_jax, jax_orbit, n, one_torch_thread, t  # noqa: F401

W = H = 32
N = 300
FIELDS = ("means", "scales", "quats", "colors", "opacities", "shs")


def scene(sh_degree=3, seed=0) -> dict:
    """Seeded Gaussians in front of two orbit cameras: a numpy params tree."""
    rng = np.random.default_rng(seed)
    k = jgmath.sh_deg2dim(sh_degree) - 1
    return {
        "means": rng.uniform(-0.6, 0.6, (N, 3)).astype(np.float32),
        "scales": np.log(rng.uniform(0.02, 0.12, (N, 3))).astype(np.float32),
        "quats": rng.normal(size=(N, 4)).astype(np.float32),
        "colors": rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32),
        "shs": (rng.normal(size=(N, k, 3)) * 0.2).astype(np.float32),
        "opacities": rng.normal(0.5, 1.0, (N, 1)).astype(np.float32),
    }


def jcams():
    return jax_orbit(radius=2.5, elevation_degrees=15.0, num_samples=2, width=W, height=H)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(64, gmath.sh_deg2dim(deg), 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    w = rng.normal(size=(64, 3)).astype(np.float32)

    def loss_j(s, d):
        return jnp.sum(jgmath.eval_sh(deg, s, d) * w)

    gs_j, gd_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(dirs))
    s_t, d_t = t(sh).requires_grad_(), t(dirs).requires_grad_()
    out = gmath.eval_sh(deg, s_t, d_t)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(n(out), np.asarray(jgmath.eval_sh(deg, sh, dirs)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n(s_t.grad), np.asarray(gs_j), rtol=1e-5, atol=1e-6)
    g_dirs = np.zeros_like(dirs) if d_t.grad is None else n(d_t.grad)   # unused at degree 0
    np.testing.assert_allclose(g_dirs, np.asarray(gd_j), rtol=1e-5, atol=1e-5)
    assert gmath.sh_dim2deg(gmath.sh_deg2dim(deg)) == jgmath.sh_dim2deg(
        jgmath.sh_deg2dim(deg)) == deg
    np.testing.assert_allclose(n(gmath.sh2rgb(gmath.rgb2sh(t(w)))), w, rtol=1e-5, atol=1e-6)


def test_rasterize_with_sh_matches_jax():
    p = scene()
    cam = jcams()[0]
    colors = np.concatenate((np.asarray(jgmath.rgb2sh(p["colors"][:, None])), p["shs"]), 1)
    quats = p["quats"] / np.linalg.norm(p["quats"], axis=-1, keepdims=True)
    args = tuple(a.astype(np.float32) for a in (
        p["means"], quats, np.exp(p["scales"]), 1 / (1 + np.exp(-p["opacities"][:, 0])), colors))
    wimg = np.random.default_rng(5).normal(size=(H, W, 4)).astype(np.float32)

    def loss_j(means, cols):
        img, alpha, _ = jrasterize(means, *map(jnp.asarray, args[1:4]), cols, cam.view_matrix,
                                   cam.intrinsic_matrix, W, H, sh_degree=3)
        out = jnp.concatenate((img, alpha), -1)
        return jnp.sum(out * wimg), out

    (gm_j, gc_j), out_j = jax.jit(jax.grad(loss_j, argnums=(0, 1), has_aux=True))(
        jnp.asarray(p["means"]), jnp.asarray(colors))
    tc = cameras_from_jax(cam)
    means_t, cols_t = t(p["means"]).requires_grad_(), t(colors).requires_grad_()
    img, alpha, _ = rasterize(means_t, t(quats), t(args[2]), t(args[3]), cols_t,
                              tc.view_matrix, tc.intrinsic_matrix, W, H, sh_degree=3)
    out = torch.cat((img, alpha), -1)
    (out * t(wimg)).sum().backward()
    assert float(alpha.detach().max()) > 0.5
    np.testing.assert_allclose(n(out), np.asarray(out_j), atol=1e-3)
    close_grads("means", n(means_t.grad), gm_j)
    close_grads("sh colours", n(cols_t.grad), gc_j)


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_render_rgba_matches_jax(mode):
    p = scene()
    cam = jcams()[1]
    mj = JGSplatter(rasterize_mode=mode)
    mt = GSplatter(rasterize_mode=mode, device="cpu")
    sj = jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()})
    st = splats_from_numpy(p)
    render_j = jax.jit(mj.render_rgba, static_argnames="max_sh_degree")
    for max_deg in (None, 1):
        rgba_j, info_j = render_j(sj, cam, max_sh_degree=max_deg)
        rgba_t, info_t = mt.render_rgba(st, cameras_from_jax(cam), max_sh_degree=max_deg)
        np.testing.assert_allclose(n(rgba_t), np.asarray(rgba_j), atol=1e-3)
        np.testing.assert_array_equal(n(info_t["radii"]), np.asarray(info_j["radii"]))
    rgb_t, _ = mt.render_rgb(st, cameras_from_jax(cam), torch.tensor([0.2, 0.4, 0.6]))
    rgb_j, _ = jax.jit(mj.render_rgb)(sj, cam, jnp.asarray([0.2, 0.4, 0.6]))
    np.testing.assert_allclose(n(rgb_t), np.asarray(rgb_j), atol=1e-3)


def test_unported_modes_raise():
    """Every mode of the JAX model builds (2dgs too), render_depth gives
    [H, W, 2] in each, and an unknown mode still raises."""
    st = splats_from_numpy(scene())
    cam = cameras_from_jax(jcams()[0])
    for mode in ("classic", "antialiased", "2dgs"):
        depth = GSplatter(rasterize_mode=mode, device="cpu").render_depth(st, cam)
        assert depth.shape == (H, W, 2) and bool(torch.isfinite(depth).all()), mode
    with pytest.raises(ValueError, match="rasterize_mode"):
        GSplatter(rasterize_mode="3dgs", device="cpu")


def adam_moments(p: dict, seed: int, mu_scale: float = 1e-3) -> dict:
    """Seeded Adam moments for every optimised leaf, of the size of a few
    steps' gradients (so an update depends smoothly on the new gradient)."""
    rng = np.random.default_rng(seed)
    return {k: {"mu": (rng.normal(size=p[k].shape) * mu_scale).astype(np.float32),
                "nu": rng.uniform(1e-6, 4e-6, p[k].shape).astype(np.float32), "count": 10}
            for k in FIELDS}


def jax_opt_state(trainer, params, moments):
    state = trainer.optimizers.init({k: params[k] for k in trainer.optimizers.txs})
    out = {}
    for k, s in state.items():
        adam, rest = s[0], s[1:]
        m = moments[k]
        sched = tuple(r._replace(count=jnp.asarray(m["count"], jnp.int32)) for r in rest)
        out[k] = (optax.ScaleByAdamState(count=jnp.asarray(m["count"], jnp.int32),
                                         mu=jnp.asarray(m["mu"]), nu=jnp.asarray(m["nu"])),
                  ) + sched
    return out


def test_train_step_matches_jax():
    p = scene()
    cams = jcams()
    gt = np.random.default_rng(7).uniform(0, 1, (2, H, W, 4)).astype(np.float32)
    cfg = dict(batch_size=2)
    # mu starts at zero, so the new mu is (1 - b1) times the step's gradient
    moments = adam_moments(p, 1, mu_scale=0.0)

    trainer_j = JTrainer(JConfig(**cfg), JGSplatter(background_color="black"), dataset_size=2)
    state = trainer_j.init_state(jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()}))
    state["opt_state"] = jax_opt_state(trainer_j, state["params"], moments)
    state["vis_counts"] = jnp.full((N,), 3.0)
    new_j, metrics_j = trainer_j.train_step(state, cams, jnp.asarray(gt), jax.random.key(0), 2)

    trainer_t = GSplatTrainer(GSplatTrainerConfig(**cfg),
                              GSplatter(background_color="black", device="cpu"), dataset_size=2)
    trainer_t.init_state(splats_from_numpy(p))
    adam_from_numpy(trainer_t.optimizers, moments)
    trainer_t.vis_counts.fill_(3.0)
    metrics_t = trainer_t.train_step(cameras_from_jax(cams), t(gt), max_sh_degree=2)

    assert int(metrics_t["nonfinite_grads"]) == 0 and int(metrics_t["num_gaussians"]) == N
    assert 0 < float(metrics_t["pair_fill"]) <= 1
    np.testing.assert_allclose(float(metrics_t["loss"]), float(metrics_j["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics_t["psnr"]), float(metrics_j["psnr"]), atol=1e-2)
    np.testing.assert_array_equal(n(trainer_t.vis_counts), np.asarray(new_j["vis_counts"]))
    assert float(trainer_t.vis_counts.max()) == 5.0      # seen by both cameras
    close_grads("xys_grad_norm", n(trainer_t.xys_grad_norm), new_j["xys_grad_norm"])
    for k in FIELDS:
        grad_j = np.asarray(new_j["opt_state"][k][0].mu) / (1.0 - 0.9)
        assert np.abs(grad_j).max() > 0, k
        close_grads(f"{k} grad", n(trainer_t.params[k].grad), grad_j)
        with pytest.raises(AssertionError):   # the check sees a zero gradient
            close_grads(f"{k} grad", np.zeros_like(grad_j), grad_j)
    got = splats_to_numpy(trainer_t.splats())
    for k in FIELDS:
        step_j = np.asarray(new_j["params"][k]) - p[k]
        step_t = got[k] - p[k]
        assert np.abs(step_j).max() > 0, k
        assert np.abs(step_t - step_j).max() <= 2e-2 * np.abs(step_j).max(), k
    moved = adam_to_numpy(trainer_t.optimizers)
    for k in FIELDS:
        assert moved[k]["count"] == 11
        close_grads(f"{k} mu", moved[k]["mu"], new_j["opt_state"][k][0].mu)


def test_schedule_and_sh_degree_match_jax():
    mj, mt = JGSplatter(), GSplatter(device="cpu")
    tj = JTrainer(JConfig(), mj, dataset_size=4)
    tt = GSplatTrainer(GSplatTrainerConfig(), mt, dataset_size=4)
    for step in (0, 999, 1000, 2500, 9000):
        assert tt.max_sh_degree_at(step) == tj.max_sh_degree_at(step)
    assert list(tt.specs) == list(tj.optimizers.specs)
    for k, spec in tj.optimizers.specs.items():
        assert (tt.specs[k].lr, tt.specs[k].eps, tt.specs[k].lr_decay) == (
            spec.lr, spec.eps, spec.lr_decay), k


def densify_inputs():
    p = scene(sh_degree=1, seed=3)
    rng = np.random.default_rng(4)
    # thresholds sit between the values, never on them
    p["scales"][:100] = np.log(0.005)              # small: duplicated if their grads are high
    p["scales"][250:260, 0] = np.log(0.7)          # too large: culled by scale
    p["opacities"][:20] = -4.0                     # transparent: culled
    grad = rng.uniform(0, 1e-3, N).astype(np.float32)
    grad[rng.uniform(size=N) < 0.5] = 1e-6
    vis = rng.integers(1, 5, N).astype(np.float32)
    return p, grad, vis


@pytest.mark.parametrize("scale_thresh", [None, 0.5])
def test_densify_and_cull_match_jax(scale_thresh):
    p, grad, vis = densify_inputs()
    kw = dict(last_wh=(64, 48), densify_grad_thresh=0.0002, densify_size_thresh=0.01,
              num_splits=2, cull_alpha_thresh=0.1, cull_scale_thresh=scale_thresh)
    sj = jsplats.Splats(**{k: jnp.asarray(v) for k, v in p.items()})
    key = jax.random.key(11)
    new_j, map_j = jsplats.densify_and_cull(sj, key, xys_grad_norm=jnp.asarray(grad),
                                            vis_counts=jnp.asarray(vis), **kw)
    # the split's draws: jax.random.normal(key, (num_splits, N_split, 3)),
    # N_split counted as splats.py:167-173 counts it
    split_mask = (0.5 * 64 * (grad / np.maximum(vis, 1.0)) > 0.0002) & (
        np.asarray(jnp.exp(sj.scales).max(axis=-1)) > 0.01)
    n_split = int(split_mask.sum())
    assert 0 < n_split and (map_j >= 0).sum() > 0
    randn = t(jax.random.normal(key, (2, n_split, 3)))
    new_t, map_t = tsplats.densify_and_cull(
        splats_from_numpy(p), xys_grad_norm=t(grad), vis_counts=t(vis), randn=randn, **kw)
    np.testing.assert_array_equal(n(map_t), map_j)
    got = splats_to_numpy(new_t)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(new_j, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # split alone, from the same draws
    sub = {k: v[:40] for k, v in p.items()}
    ch_j = jax.jit(jsplats.split, static_argnums=2)(
        jsplats.Splats(**{k: jnp.asarray(v) for k, v in sub.items()}), key, 2)
    ch_t = tsplats.split(splats_from_numpy(sub), 2, randn=t(jax.random.normal(key, (2, 40, 3))))
    for k in FIELDS:
        np.testing.assert_allclose(n(getattr(ch_t, k)), np.asarray(getattr(ch_j, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # cull
    cj, sel_j = jsplats.cull(sj, cull_alpha_thresh=0.1, cull_scale_thresh=scale_thresh)
    ct, sel_t = tsplats.cull(splats_from_numpy(p), cull_alpha_thresh=0.1,
                             cull_scale_thresh=scale_thresh)
    np.testing.assert_array_equal(n(sel_t), sel_j)
    np.testing.assert_array_equal(n(ct.means), np.asarray(cj.means))


def test_mutate_params_matches_optax():
    p, _, _ = densify_inputs()
    moments = adam_moments(p, 2)
    trainer_j = JTrainer(JConfig(), JGSplatter(sh_degree=1), dataset_size=2)
    params_j = {k: jnp.asarray(v) for k, v in p.items()}
    state_j = jax_opt_state(trainer_j, params_j, moments)
    trainer_t = GSplatTrainer(GSplatTrainerConfig(), GSplatter(sh_degree=1, device="cpu"), 2)
    trainer_t.init_state(splats_from_numpy(p))
    adam_from_numpy(trainer_t.optimizers, moments)
    param_map = np.random.default_rng(0).integers(-1, N, 450)
    # the surgery through the trainer, as after_update applies it
    new = tsplats.Splats(**{k: torch.zeros((450,) + v.shape[1:]) for k, v in p.items()})
    trainer_t._apply_map(new, torch.as_tensor(param_map))
    got = adam_to_numpy(trainer_t.optimizers)
    for k in FIELDS:
        want = mutate_optax_state(state_j[k], param_map=param_map)[0]
        np.testing.assert_array_equal(got[k]["mu"], np.asarray(want.mu), err_msg=k)
        np.testing.assert_array_equal(got[k]["nu"], np.asarray(want.nu), err_msg=k)
        assert got[k]["count"] == int(want.count) == 10
        assert trainer_t.params[k].shape[0] == 450
    assert trainer_t.xys_grad_norm.shape == (450,) and float(trainer_t.vis_counts.min()) == 1.0
    trainer_t.optimizers.mutate_params("opacities", clear=True)
    cleared = adam_to_numpy(trainer_t.optimizers)["opacities"]
    assert not cleared["mu"].any() and not cleared["nu"].any() and cleared["count"] == 10


def test_after_update_schedule():
    """The densify / reset schedule of gsplat_trainer.py:199-259: densify at
    step % (reset_alpha_every x refine_every) > dataset_size +
    refine_every, reset the opacities at == refine_every."""
    p, grad, vis = densify_inputs()
    cfg = GSplatTrainerConfig(warmup_length=1, refine_every=2, reset_alpha_every=5)
    trainer = GSplatTrainer(cfg, GSplatter(sh_degree=1, device="cpu"), dataset_size=2)
    trainer.init_state(splats_from_numpy(p))
    trainer.xys_grad_norm.copy_(t(grad))
    trainer.vis_counts.copy_(t(vis))
    assert trainer.after_update(1, (64, 48)) is None and trainer.after_update(3, (64, 48)) is None
    assert trainer.after_update(2, (64, 48)) == {"param_map": None, "reset_opacities": True}
    assert float(trainer.params["opacities"].detach().max()) <= np.log(0.2 / 0.8) + 1e-6
    out = trainer.after_update(6, (64, 48), generator=torch.Generator().manual_seed(0))
    assert out["param_map"] is not None and not out["reset_opacities"]
    assert trainer.params["means"].shape[0] == len(out["param_map"]) != N


def test_random_splats_match_jax():
    key = jax.random.key(3)
    sj = jsplats.Splats.random(key, 4500, sh_degree=2, random_scale=0.8)
    k1, k2 = jax.random.split(key)
    st = tsplats.Splats.random(4500, sh_degree=2, random_scale=0.8, device="cpu",
                               uniform=t(jax.random.uniform(k1, (4500, 3))),
                               quat_normal=t(jax.random.normal(k2, (4500, 4))))
    for k in FIELDS:
        np.testing.assert_allclose(n(getattr(st, k)), np.asarray(getattr(sj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert st.sh_degree == 2 and st.shs.shape == (4500, 8, 3)
    # blocks of 4096 rows against all 4500 points
    d = tsplats.mean_knn_distance(st.means, k=3)
    np.testing.assert_allclose(n(d), np.asarray(jsplats._mean_knn_distance(sj.means, 3)),
                               rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    drawn = tsplats.Splats.random(64, sh_degree=0, random_scale=1.0, generator=g, device="cpu")
    assert drawn.shs.shape == (64, 0, 3) and float(drawn.means.abs().max()) <= 1.0
