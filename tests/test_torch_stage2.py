"""Port parity: stage 2 (GeoSplatterMC) against the JAX package on the CPU.

The tiny configuration of tests/test_dp_geosplat.py (grid 10, num_samples_x
2, shadow_steps 4, 2 cameras at 32x32) with a 32-texel triplane and 1,024
render faces: the stage-1 hand-off, the render, one trainer step and the
optimizer with its warm-up (the train task and the hand-offs are in
tests/test_torch_stage2_task.py). JAX renders through its pairs backend with the
Pallas kernels in interpret mode; the port through its kernels' plain
versions. The random draws and the jitter come from jax.random and are
handed to both (tests/torch_parity.py replays the key splits).

Tolerances, the stage-1 ones of tests/test_torch_trainer.py: images atol
1e-3 (transmittance-cutoff flips), loss terms rtol 1e-4, PSNR atol 1e-2,
gradient groups 1 % in L2 and 2 % of the largest entry (close_grads), the
optimizer rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.models.encodings import TriplaneEncoding as JTriplane
from geosplatting_tpu.models.geosplat import GeoSplatter as JGeoSplatter
from geosplatting_tpu.models.geosplat import SharedField as JSharedField
from geosplatting_tpu.models.geosplat_mc import GeoSplatterMC as JGeoSplatterMC
from geosplatting_tpu.models.geosplat_mc import export_stage1 as jexport_stage1
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu.ops.ssim import ssim_l1_loss as jssim_l1_loss
from geosplatting_tpu.train.geosplat_mc_trainer import GeoSplatMCTrainer as JTrainer
from geosplatting_tpu.train.geosplat_mc_trainer import GeoSplatMCTrainerConfig as JConfig
from geosplatting_tpu_torch.convert import params_from_numpy, params_to_numpy
from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
    GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
)

from .test_torch_geosplat import close_grads
from .test_torch_trainer import sphere_gt
from .torch_parity import (  # noqa: F401
    cameras_from_jax, jax_orbit, jax_step_draws, n, one_torch_thread, shade_draws, t,
)

W = H = 32
CFG = dict(resolution=10, scale=1.0, num_samples_x=2, shadow_steps=4, max_render_faces=1024)
TRI = 32
FACES = 1024            # min(max_render_faces, 4 x the grid's surface-edge budget)
NPTS = 6 * FACES
STEP = 60.0


@pytest.fixture(scope="module", autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


def jax_field(with_occ):
    return JSharedField(trunk=JTriplane(resolution=TRI, num_components=32, init_scale=0.03),
                        with_occ=with_occ)


def make_stage2():
    """A JAX stage-1 export (off-grid SDF sphere, a smooth cubemap), the
    JAX stage-2 model and parameters built from it, and the cameras."""
    s1 = JGeoSplatter(resolution=10, light_resolution=16, scale=1.0, field=jax_field(False),
                      backend="pairs")
    p1 = jax.jit(s1.init)(jax.random.key(11))
    p1["sdf"] = jnp.linalg.norm(s1.make_grid().base_vertices() - 0.03, axis=-1) - 0.45
    # off the symmetric zeros of a fresh init: there the FlexiCubes gradient
    # sits at kinks, and an ulp moves it by percents
    rng = np.random.default_rng(0)
    for k in ("deform", "weights"):
        p1[k] = jnp.asarray(rng.normal(size=p1[k].shape) * 0.1, jnp.float32)
    f, i, j, c = np.meshgrid(*(np.arange(k) for k in p1["cubemap"].shape), indexing="ij")
    p1["cubemap"] = jnp.asarray(0.3 + 0.2 * (i + j) / 32 + 0.05 * f + 0.1 * c * c, jnp.float32)
    export = jax.tree.map(np.asarray, jexport_stage1(s1, p1))
    mj = JGeoSplatterMC(field=jax_field(True), backend="pairs", **CFG)
    params = jax.jit(mj.init_from_stage1)(export, jax.random.key(12))
    cams = jax_orbit(radius=2.0, elevation_degrees=20.0, num_samples=2, width=W, height=H)
    return mj, params, cams, export


def jax_step(mj, params, cams, gt, key, step) -> dict:
    """The JAX trainer's step as train_step_accum computes it (one camera at
    a time, summed, scaled by 1/B), keeping each camera's image: ONE
    compiled per-camera program serves the render and the gradients. The
    per-camera loss is geosplat_mc_trainer._local_loss, line for line."""
    trainer_j = JTrainer(JConfig(batch_size=2), mj)
    c = trainer_j.config
    d = jax_step_draws(key, gt.shape, FACES, NPTS, CFG["num_samples_x"])
    rw = trainer_j._reg_weights(jnp.asarray(step, jnp.float32))

    def cam_loss(p, cam, gt_i, bg, sk):
        rgba, reg, aux = mj.render(p, cam, d["k_render"], reg_weights=rw,
                                   kd_perturb_std=c.kd_perturb_std,
                                   ks_perturb_std=c.ks_perturb_std, shade_keys=sk)
        mask = gt_i[..., 3:]
        img1 = rgba[..., :3] + (1 - rgba[..., 3:]) * bg
        img2 = jimages.srgb2rgb(gt_i[..., :3]) * mask + (1 - mask) * bg
        loss = jssim_l1_loss(img1, img2) + 5.0 * jnp.mean((mask - rgba[..., 3:]) ** 2)
        pred_srgb = jimages.rgb2srgb(jnp.clip(rgba[..., :3], 0, 1)) * rgba[..., 3:]
        mse = jnp.mean((pred_srgb - gt_i[..., :3] * mask) ** 2)
        return loss + reg, ((loss, mse, reg), aux, rgba)

    grad_fn = jax.jit(jax.grad(cam_loss, has_aux=True))
    # the sums and the update in numpy / one program: eager JAX compiles
    # every small op on its own
    grads, sums, rgbas, regs, aux = None, np.zeros(3), [], [], None
    for i in range(gt.shape[0]):
        cam_i, gt_i, bg_i, sk_i = trainer_j._slice_cam(
            cams, jnp.asarray(gt), jnp.asarray(d["background"]), d["shade_keys"],
            jnp.asarray(i, jnp.int32))
        g_i, (parts, a_i, rgba_i) = jax.device_get(grad_fn(params, cam_i, gt_i, bg_i, sk_i))
        rgbas.append(rgba_i[0])
        regs.append(float(parts[2]))
        sums += np.asarray(parts, np.float32)
        grads = g_i if grads is None else jax.tree.map(np.add, grads, g_i)
        aux = a_i if aux is None else jax.tree.map(np.maximum, aux, a_i)
    inv = np.float32(1.0 / gt.shape[0])
    grads = jax.tree.map(lambda g: g * inv, grads)
    metrics = jax.jit(lambda p, g, l, m, r, a: trainer_j._apply_grads(
        trainer_j.init_state(p), g, l, m, r, a)[1])(params, grads, *(sums * inv), aux)
    return {"draws": d, "rw": {k: float(v) for k, v in rw.items()},
            "groups": trainer_j._groups(grads), "metrics": metrics, "rgba": np.stack(rgbas),
            "reg": regs, "aux": aux}


@pytest.fixture(scope="module")
def stage2():
    return make_stage2()


@pytest.fixture(scope="module")
def jax_ref(stage2):
    mj, params, cams, _ = stage2
    gt = sphere_gt(cams)
    return gt, jax_step(mj, params, cams, gt, jax.random.key(5), STEP)


def torch_model(params):
    m = GeoSplatterMC(triplane_resolution=TRI, device="cpu", **CFG)
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return m


def test_init_from_stage1_and_params_round_trip(stage2):
    mj, params, _, export = stage2
    m = GeoSplatterMC(triplane_resolution=TRI, device="cpu", **CFG)
    m.init_from_stage1(export)
    tree = params_to_numpy(m.state_dict())
    for k in ("sdf", "deform", "weights", "exposure"):
        np.testing.assert_array_equal(tree[k], np.asarray(params[k]), err_msg=k)
    np.testing.assert_allclose(tree["latlng"], np.asarray(params["latlng"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tree["field"]["planes"], np.asarray(params["field"]["planes"]))
    for k, v in params["field"]["ks"].items():
        np.testing.assert_array_equal(tree["field"]["ks"][k], np.asarray(v))
    assert sorted(tree["field"]) == sorted(params["field"])
    # the JAX tree through the port's state dict and back, unchanged
    back = params_to_numpy(torch_model(params).state_dict())
    flat_a, def_a = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, params))
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # a hash-field bundle does not fit the shared field
    with pytest.raises(ValueError, match="field family"):
        m.init_from_stage1({**export, "ks_enc": {"grid": np.zeros(3)}})
    with pytest.raises(ValueError, match="shape"):
        GeoSplatterMC(resolution=12, scale=1.0, triplane_resolution=TRI,
                      device="cpu").init_from_stage1(export)


def test_render_matches_jax(stage2, jax_ref):
    """Both cameras in one call of the port's render against the JAX
    per-camera renders, with the trainer's draws."""
    _, params, cams, _ = stage2
    _, ref = jax_ref
    d = ref["draws"]
    mt = torch_model(params)
    with torch.no_grad():
        rgba_t, reg_t, aux_t = mt.render(cameras_from_jax(cams), reg_weights=ref["rw"],
                                         jitter_noise=t(d["jitter"]),
                                         draws=[shade_draws(x) for x in d["draws"]])
    np.testing.assert_allclose(n(rgba_t), ref["rgba"], atol=1e-3)
    np.testing.assert_allclose(float(reg_t), ref["reg"][0], rtol=1e-4)
    for k in ("num_gaussians", "num_surf_cubes", "num_surf_edges", "total_pairs", "max_pairs"):
        assert int(aux_t[k]) == int(ref["aux"][k]), k
    assert 0 < int(aux_t["num_gaussians"]) < NPTS and float(rgba_t[..., 3].max()) > 0.5
    # ACES is ported (tests/test_torch_options.py holds it to the JAX curve);
    # an unknown tone mapping raises
    with pytest.raises(ValueError, match="tone_type"):
        mt.render(cameras_from_jax(cams)[:1], tone_type="filmic")
    mj = stage2[0]
    np.testing.assert_array_equal(n(mt.get_background(training=False)),
                                  np.asarray(mj.get_background(None, training=False)))


def test_train_step_matches_jax(stage2, jax_ref):
    """One step's gradients before Adam (an Adam step turns near-zero
    gradients into +-lr) and its metrics."""
    _, params, cams, _ = stage2
    gt, ref = jax_ref
    d, metrics_j = ref["draws"], ref["metrics"]
    mt = torch_model(params)
    trainer_t = GeoSplatMCTrainer(GeoSplatMCTrainerConfig(batch_size=2), mt)
    metrics_t = trainer_t.train_step(
        cameras_from_jax(cams), t(gt), STEP, background=t(d["background"]),
        jitter_noise=t(d["jitter"]), draws=[shade_draws(x) for x in d["draws"]],
    )
    assert int(metrics_t["nonfinite_grads"]) == int(metrics_j["nonfinite_grads"]) == 0
    for k in ("loss", "reg"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(metrics_t["splat_psnr"]), float(metrics_j["splat_psnr"]),
                               atol=1e-2)
    assert int(metrics_t["num_gaussians"]) == int(metrics_j["num_gaussians"])
    for k in ("pair_fill", "exposure"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-6, err_msg=k)
    groups_t = trainer_t.param_groups()
    assert sorted(groups_t) == sorted(ref["groups"])
    for name, ps in groups_t.items():
        leaves_j = jax.tree_util.tree_leaves(ref["groups"][name])
        assert len(leaves_j) == len(ps), name
        for gj, p in zip(leaves_j, ps):
            close_grads(name, n(p.grad) / (64.0 if name == "light" else 1.0), np.asarray(gj))


def test_optimizer_and_warm_up_match_optax(stage2):
    from geosplatting_tpu.train.optim import make_schedule as jsched

    from geosplatting_tpu_torch.train.optim import make_schedule

    for kw in (dict(lr_decay=800, warm_up=50), dict(warm_up=10), dict(lr_decay=100)):
        sj, st = jsched(3e-3, **kw), make_schedule(3e-3, **kw)
        for s in (0, 1, 9, 10, 11, 49, 50, 51, 400):
            np.testing.assert_allclose(st(s), float(sj(s)), rtol=1e-6, err_msg=f"{kw} {s}")
    mj, params, _, _ = stage2
    trainer_j = JTrainer(JConfig(geometry_warm_up=2), mj)
    groups = trainer_j._groups(params)
    opt_state = jax.jit(trainer_j.optimizers.init)(groups)
    trainer_t = GeoSplatMCTrainer(GeoSplatMCTrainerConfig(geometry_warm_up=2), torch_model(params))
    update = jax.jit(trainer_j.optimizers.update)
    rng = np.random.default_rng(0)
    for _ in range(4):  # through the geometry groups' warm-up
        g_np = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), groups)
        groups, opt_state = update(g_np, opt_state, groups)
        for name, ps in trainer_t.param_groups().items():
            for gj, p in zip(jax.tree_util.tree_leaves(g_np[name]), ps):
                p.grad = t(gj)
        trainer_t.optimizers.step()
    for name, ps in trainer_t.param_groups().items():
        for pj, p in zip(jax.tree_util.tree_leaves(groups[name]), ps):
            np.testing.assert_allclose(n(p), np.asarray(pj), rtol=1e-5, atol=1e-6, err_msg=name)
    for step in (0.0, 120.0, 800.0):
        rw_j = trainer_j._reg_weights(jnp.asarray(step, jnp.float32))
        for k, v in trainer_t.reg_weights(step).items():
            np.testing.assert_allclose(v, float(rw_j[k]), rtol=1e-6, err_msg=k)
