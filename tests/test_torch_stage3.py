"""Port parity: stage 3 (GeoSplatterDefer) against the JAX package on the
CPU: the stage-2 hand-off, the render with its ks jitter regularization and
every parameter group's gradient, one trainer step (train_step_accum: per
camera, summed, x 1/B), the update with its light scale, sanitizing and
clamps, the attribute maps and the relit render with albedo scaling.

The configuration is that of tests/test_torch_stage2.py (grid 10,
num_samples_x 2, shadow_steps 4, 2 cameras at 32x32, a 32-texel triplane),
from a JAX stage-2 model with random deform / weights (ROADMAP C), whose
export, compacted to multiples of 256 rows, starts both stage-3 models. JAX
renders through its pairs backend with the Pallas kernels in interpret
mode; the port through its kernels' plain versions. The draws come from
jax.random and are handed to both (tests/torch_parity.py replays the key
splits).

Tolerances, stage 2's: images atol 1e-3 (transmittance-cutoff flips), loss
terms rtol 1e-4, PSNR atol 1e-2, gradient groups 1 % in L2 and 2 % of the
largest entry (close_grads), the optimizer rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.models.geosplat_defer import GeoSplatterDefer as JDefer
from geosplatting_tpu.models.geosplat_mc import compact_export as jcompact_export
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu.ops.ssim import ssim_l1_loss as jssim_l1_loss
from geosplatting_tpu.train.geosplat_defer_trainer import GeoSplatDeferTrainer as JTrainer
from geosplatting_tpu.train.geosplat_defer_trainer import GeoSplatDeferTrainerConfig as JConfig
from geosplatting_tpu_torch.convert import params_from_numpy, params_to_numpy
from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer, frozen_geometry
from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
    GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
)

from .test_torch_geosplat import close_grads
from .test_torch_stage2 import TRI, make_stage2
from .test_torch_trainer import sphere_gt
from .torch_parity import (  # noqa: F401
    cameras_from_jax, jax_defer_draws, jax_defer_step_draws, n, one_torch_thread,
    shade_draws, t,
)

CFG3 = dict(resolution=10, scale=1.0, num_samples_x=2, shadow_steps=4)
NSX = CFG3["num_samples_x"]
# the port's parameter of each JAX leaf
GROUP_LEAVES = {"light_hue": ["latlng_hue"], "light_value": ["latlng_value"],
                **{k: [k] for k in ("exposure", "means", "scales", "quats", "normals",
                                    "opacities", "kd", "occ")},
                "ks": ["ks_enc.ks.w0", "ks_enc.ks.w1", "ks_enc.planes"]}


@pytest.fixture(scope="module", autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


def make_stage3():
    """The JAX stage-3 model, parameters and frozen geometry from the
    compacted export of tests/test_torch_stage2.py's stage-2 model, the
    cameras and the export."""
    mj, params2, cams, _ = make_stage2()
    export = jcompact_export(jax.device_get(jax.jit(mj.export_model)(
        params2, jax.random.key(0))), pad_to=256)
    md = JDefer(backend="pairs", **CFG3)
    # device arrays, as load_export gives them (a closure over a numpy
    # plane cannot be indexed by a traced index)
    params = jax.tree.map(jnp.asarray, md.init_from_stage2(export, jax.random.key(1)))
    return md, params, md.frozen_geometry(export), cams, export


def torch_model(params, export, **kw):
    m = GeoSplatterDefer(num_gaussians=np.shape(params["means"])[0], ks_resolution=TRI,
                         device="cpu", **CFG3, **kw)
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    m.set_geometry(frozen_geometry(export))
    return m


def jax_step(md, params, geom, cams, gt, key) -> dict:
    """The JAX trainer's train_step_accum, keeping each camera's image: ONE
    compiled per-camera program serves the render and the gradients. The
    per-camera loss is geosplat_defer_trainer._local_loss, line for line."""
    trainer_j = JTrainer(JConfig(batch_size=2), md)
    c = trainer_j.config
    d = jax_defer_step_draws(key, gt.shape, np.shape(params["means"])[0], NSX)

    def cam_loss(p, cam, gt_i, bg, sk):
        rgba, reg, aux = md.render(p, geom, cam, d["k_render"], ks_weight=c.ks_reg,
                                   shade_keys=sk)
        gt_c = jnp.clip(gt_i, 0, 1)
        gt_linear = jimages.srgb2rgb(gt_c[..., :3])
        mask = gt_c[..., 3:]
        loss = jssim_l1_loss(rgba[..., :3] + (1 - rgba[..., 3:]) * bg,
                             gt_linear * mask + (1 - mask) * bg)
        gt_comp = gt_linear * mask + (1 - mask)
        kd = md.render_attribute(p, cam, "kd")[..., :3]

        def sg(x):
            return jnp.abs(x[:, :, 1:] - x[:, :, :-1]), jnp.abs(x[:, 1:, :] - x[:, :-1, :])

        (px, py), (gx, gy) = sg(kd), sg(gt_comp)
        reg = reg + ((px * jnp.exp(-gx)).mean() + (py * jnp.exp(-gy)).mean()) * c.kd_reg
        pred_srgb = jimages.rgb2srgb(jnp.clip(rgba[..., :3], 0, 1)) * rgba[..., 3:]
        mse = jnp.mean((pred_srgb - gt_c[..., :3] * mask) ** 2)
        return loss + reg, ((loss, mse, reg), aux, rgba)

    grad_fn = jax.jit(jax.grad(cam_loss, has_aux=True))
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
    apply = jax.jit(lambda s, g, l, m, r, a: trainer_j._apply_grads(s, g, l, m, r, a))
    state, metrics = apply(trainer_j.init_state(params), grads, *(sums * inv), aux)
    return {"draws": d, "grads": grads, "metrics": metrics, "rgba": np.stack(rgbas),
            "reg": regs, "aux": aux, "trainer": trainer_j, "sums": sums * inv}


@pytest.fixture(scope="module")
def stage3():
    return make_stage3()


@pytest.fixture(scope="module")
def jax_ref(stage3):
    md, params, geom, cams, _ = stage3
    gt = sphere_gt(cams)
    return gt, jax_step(md, params, geom, cams, gt, jax.random.key(5))


def test_init_from_stage2_and_params_round_trip(stage3):
    _, params, _, _, export = stage3
    m = GeoSplatterDefer(num_gaussians=export["means"].shape[0], ks_resolution=TRI,
                         device="cpu", **CFG3)
    m.init_from_stage2(export)
    tree = params_to_numpy(m.state_dict())
    want = jax.tree.map(np.asarray, params)
    flat_a, def_a = jax.tree_util.tree_flatten(want)
    flat_b, def_b = jax.tree_util.tree_flatten(tree)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(n(m.geometry["mesh_i"]), export["mc_indices"])
    with pytest.raises(NotImplementedError, match="hashgrid"):
        m.init_from_stage2({**export, "ks_enc": {"grid": np.zeros(3)}})
    with pytest.raises(ValueError, match="shape"):
        GeoSplatterDefer(num_gaussians=7, ks_resolution=TRI, device="cpu",
                         **CFG3).init_from_stage2(export)


def test_render_matches_jax(stage3, jax_ref):
    """Both cameras in one call of the port's render, with the trainer's
    draws, against the JAX per-camera renders; and the ks jitter reg."""
    _, params, _, cams, export = stage3
    _, ref = jax_ref
    d = ref["draws"]
    mt = torch_model(params, export)
    with torch.no_grad():
        rgba, reg, aux = mt.render(cameras_from_jax(cams), ks_weight=0.05,
                                   jitter_noise=t(d["jitter"]),
                                   draws=[shade_draws(x) for x in d["draws"]])
    np.testing.assert_allclose(n(rgba), ref["rgba"], atol=1e-3)
    assert float(rgba[..., 3].max()) > 0.5 and float(rgba[..., :3].max()) > 0.05
    assert int(aux["total_pairs"]) == int(ref["aux"]["total_pairs"])
    assert aux["max_pairs"] == int(ref["aux"]["max_pairs"]) and aux["mesh_tile_fill"] <= 1
    # the ks jitter term (the kd term joins it in the train step): the same
    # noise through the JAX ks predictor
    x = np.clip(np.asarray(params["means"]) / CFG3["scale"], -1, 1)
    xj = np.clip((np.asarray(params["means"]) + d["jitter"] * 0.01) / CFG3["scale"], -1, 1)
    from geosplatting_tpu.models.geosplat import apply_ks_bundle as japply

    ig = np.asarray(export["initial_guess"])
    ks_j = jax.nn.sigmoid(japply(params["ks_enc"], jnp.asarray(x), None) + ig)
    ksj_j = jax.nn.sigmoid(japply(params["ks_enc"], jnp.asarray(xj), None) + ig)
    np.testing.assert_allclose(float(reg), float(jnp.abs(ks_j - ksj_j).mean()) * 0.05,
                               rtol=1e-4)


def test_train_step_matches_jax(stage3, jax_ref):
    """One step's gradients before Adam (an Adam step turns near-zero
    gradients into +-lr) and its metrics."""
    _, params, _, cams, export = stage3
    gt, ref = jax_ref
    d, metrics_j = ref["draws"], ref["metrics"]
    mt = torch_model(params, export)
    trainer_t = GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=2), mt)
    metrics_t = trainer_t.train_step(
        cameras_from_jax(cams), t(gt), background=t(d["background"]),
        jitter_noise=t(d["jitter"]), draws=[shade_draws(x) for x in d["draws"]])
    assert int(metrics_t["nonfinite_grads"]) == int(metrics_j["nonfinite_grads"]) == 0
    for k in ("loss", "reg"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(metrics_t["splat_psnr"]), float(metrics_j["splat_psnr"]),
                               atol=1e-2)
    for k in ("num_gaussians", "pair_fill", "exposure"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-6, err_msg=k)
    assert metrics_t["mesh_tile_fill"] <= 1 and metrics_t["mesh_pair_fill"] <= 1
    named = dict(mt.named_parameters())
    groups_j = ref["trainer"]._groups(ref["grads"])
    assert sorted(trainer_t.param_groups()) == sorted(groups_j) == sorted(GROUP_LEAVES)
    for name, leaves in GROUP_LEAVES.items():
        for gj, leaf in zip(jax.tree_util.tree_leaves(groups_j[name]), leaves):
            scale = 64.0 if name.startswith("light") else 1.0
            close_grads(name, n(named[leaf].grad) / scale, np.asarray(gj))


def test_update_and_clamps_match_jax(stage3, jax_ref):
    """The update from the same gradients in both packages, twice: Adam with
    each group's lr and decay, the light gradients x64, a non-finite entry
    zeroed and counted, and kd / latlng_hue clamped to [0.01, 0.99] (a few
    entries start next to the bounds and are pushed across)."""
    _, params, _, _, export = stage3
    _, ref = jax_ref
    params = jax.tree.map(np.array, params)
    grads = jax.tree.map(np.array, ref["grads"])
    for k, rows in (("kd", np.s_[:10]), ("latlng_hue", np.s_[0, :10])):
        params[k][rows][:5], params[k][rows][5:] = 0.9899, 0.0101
        grads[k][rows][:5], grads[k][rows][5:] = -1.0, 1.0
    grads["means"][0, 0] = np.nan
    leaf_grads = {
        **{k: grads[k] for k in ("latlng_hue", "latlng_value", "exposure", "means", "scales",
                                 "quats", "normals", "opacities", "kd", "occ")},
        "ks_enc.planes": grads["ks_enc"]["planes"],
        **{f"ks_enc.ks.{k}": v for k, v in grads["ks_enc"]["ks"].items()}}
    mt = torch_model(params, export)
    trainer_t = GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=2), mt)
    trainer_j = ref["trainer"]
    state = trainer_j.init_state(jax.tree.map(jnp.asarray, params))
    apply = jax.jit(lambda s, g, *a: trainer_j._apply_grads(s, g, *a))
    named = dict(mt.named_parameters())
    aux_t = {**{k: torch.as_tensor(np.asarray(v)) for k, v in ref["aux"].items()},
             "mesh_tile_fill": 0.5, "mesh_pair_fill": 0.5}
    for _ in range(2):
        state, metrics_j = apply(state, grads, *ref["sums"], ref["aux"])
        for leaf, g in leaf_grads.items():
            named[leaf].grad = t(g)
        metrics_t = trainer_t._apply_grads(*(torch.tensor(x) for x in ref["sums"]), aux_t)
        assert int(metrics_t["nonfinite_grads"]) == int(metrics_j["nonfinite_grads"]) == 1
    tree = params_to_numpy(mt.state_dict())
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                            jax.tree_util.tree_leaves(tree)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6, err_msg=str(path))
    for k in ("kd", "latlng_hue"):
        assert tree[k].min() == np.float32(0.01) and tree[k].max() == np.float32(0.99), k


def test_attributes_and_relighting_match_jax(stage3):
    """kd, ks and normal maps, and the relit render (albedo scaled, occ
    collapsed, another environment, exposure 1) in the diffuse mode with
    ACES tone mapping, from one JAX program."""
    md, params, geom, cams, export = stage3
    env = (0.5 + np.random.default_rng(3).uniform(size=(8, 16, 3))).astype(np.float32)
    scaling = np.array([1.2, 0.9, 0.7], np.float32)
    key = jax.random.key(9)

    @jax.jit
    def jax_eval(p):
        relit, _, _ = md.render(p, geom, cams, key, relight_envmap=jnp.asarray(env),
                                albedo_scaling=jnp.asarray(scaling), mode="diffuse",
                                tone_type="aces")
        return relit, {a: md.render_attribute(p, cams, a, geometry=geom)
                       for a in ("kd", "ks", "normal")}

    relit_j, maps_j = jax.device_get(jax_eval(params))
    _, draws = jax_defer_draws(key, np.shape(params["means"])[0], 32 * 32, 2, NSX)
    mt = torch_model(params, export)
    cams_t = cameras_from_jax(cams)
    with torch.no_grad():
        relit_t, _, _ = mt.render(cams_t, relight_envmap=t(env), albedo_scaling=t(scaling),
                                  mode="diffuse", tone_type="aces",
                                  draws=[shade_draws(x) for x in draws])
        for a, want in maps_j.items():
            np.testing.assert_allclose(n(mt.render_attribute(cams_t, a)), want, atol=1e-3,
                                       err_msg=a)
    np.testing.assert_allclose(n(relit_t), relit_j, atol=1e-3)
    assert float(relit_t[..., :3].max()) > 0.05
    with pytest.raises(ValueError, match="mode"):
        mt.render(cams_t[:1], mode="albedo")
