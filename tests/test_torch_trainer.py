"""Port parity: one stage-1 GeoSplatTrainer.train_step from identical state,
with the background and the jitter noise drawn by jax.random exactly as
geosplat_trainer.py:180-181 and geosplat.py:860,498 draw them, against the
JAX trainer (its loss and _apply_grads, through its CPU reference
rasterizer). The optimizer is held separately: the same gradients fed to
both optimizers for a few updates must give the same parameters (Adam with
eps 1e-15 turns a first-step gradient into +-lr, so parameters after a real
step would differ by 2 lr wherever a near-zero gradient flips sign).

The first-layer weights of a field head get their gradient as a sum over
field points that cancels to ~1/60 of its terms (the ks head most of all).
A hidden unit whose ReLU pre-activation lies within rounding of 0 at some
point switches on in one package and off in the other, and that single
term moves the cancelled sum by percents. The two packages' field points
differ by ~25 ulps (the FlexiCubes crossings round differently), so a
pre-activation within ~1e-6 of 0 can take either sign; the rows of units
whose sign differs between the packages at some point (at most two per
head) are left out of that leaf's comparison."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from geosplatting_tpu.graphics import images as jimages
from geosplatting_tpu.models.geosplat import compact_faces as jcompact
from geosplatting_tpu.train.geosplat_trainer import GeoSplatTrainer as JTrainer
from geosplatting_tpu.train.geosplat_trainer import GeoSplatTrainerConfig as JConfig
from geosplatting_tpu_torch.models.geosplat import compact_faces, field_points
from geosplatting_tpu_torch.train.geosplat_trainer import (
    GeoSplatTrainer, GeoSplatTrainerConfig,
)

from .test_torch_geosplat import (  # noqa: F401
    close_grads, face_noise, jax_pairs_interpret, setup, torch_model,
)
from .torch_parity import cameras_from_jax, n, one_torch_thread, t  # noqa: F401


def sphere_gt(cams):
    """sRGB rgba views of a shaded sphere of radius 0.5 (analytic ray hits)."""
    origins, dirs = (np.asarray(a) for a in jax.jit(lambda c: c.generate_rays())(cams))
    b = (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - 0.25
    disc = b * b - c
    tt = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (tt > 0)
    nrm = (origins + tt[..., None] * dirs) / 0.5
    shade = np.clip((nrm * np.array([0.577, 0.577, 0.577])).sum(-1), 0.1, 1.0)
    rgb = np.where(hit[..., None], shade[..., None] * np.full(3, 0.8), 0.0).astype(np.float32)
    a = hit[..., None].astype(np.float32)
    return np.concatenate((np.asarray(jax.jit(jimages.rgb2srgb)(rgb)) * a, a), -1)


def jax_preacts(mj, params, noise, jitter_std) -> dict:
    """Per head, the JAX package's first-layer pre-activations at its field
    points (face centroids and their jittered twins); traceable."""
    mesh_j, _, _ = mj.get_geometry(params)
    pts_j = jnp.clip(jcompact(mesh_j, mj.max_render_faces).face_vertices().mean(1) / mj.scale,
                     -1, 1)
    planes = params["field"]["planes"]
    feats_j = jnp.concatenate([mj.field.trunk.apply(planes, x) for x in (
        pts_j, jnp.clip(pts_j + noise * jitter_std, -1, 1))])
    return {name: feats_j @ params["field"][name]["w0"].T for name in ("kd", "ks", "z")}


def relu_flips(preacts_j, mt, noise, jitter_std) -> dict:
    """Per head: hidden units whose ReLU pre-activation has opposite signs in
    the two packages at some field point, from the initial parameters."""
    with torch.no_grad():
        mesh_t, _, _ = mt.get_geometry()
        pts_t = field_points(compact_faces(mesh_t, mt.max_render_faces), mt.scale)
        feats_t = torch.cat([mt.field.trunk(x) for x in (
            pts_t, torch.clamp(pts_t + noise * jitter_std, -1, 1))])
    out = {}
    for name, h_j in preacts_j.items():
        h_t = n(feats_t @ getattr(mt.field, name).w0.T)
        out[name] = ((np.asarray(h_j) > 0) != (h_t > 0)).any(0)
    return out


def test_train_step_matches_jax():
    mj, params, cams = setup()
    trainer_j = JTrainer(JConfig(batch_size=2), mj)
    state = trainer_j.init_state(params)
    gt = sphere_gt(cams)
    step = 200.0
    key = jax.random.key(5)
    k_render, k_bg = jax.random.split(key)
    bg = jax.random.uniform(k_bg, gt[..., :3].shape)
    rw = trainer_j.reg_weights(jnp.asarray(step, jnp.float32))
    mt = torch_model(jax.tree.map(np.asarray, params))
    trainer_t = GeoSplatTrainer(GeoSplatTrainerConfig(batch_size=2), mt)
    noise = face_noise(k_render, mt)
    std = trainer_t.config.kd_perturb_std

    def loss_j(p):
        return trainer_j._local_loss(p, cams, jnp.asarray(gt), bg, rw, k_render, "face")

    def jax_side(p):
        # one compile for the gradient, the trainer's metrics and the
        # pre-activations of the flip check
        grads, ((loss, mse, reg), aux) = jax.grad(loss_j, has_aux=True)(p)
        _, metrics = trainer_j._apply_grads(state, grads, loss, mse, reg, aux)
        return grads, metrics, jax_preacts(mj, p, noise, std)

    grads, metrics_j, preacts_j = jax.jit(jax_side)(params)
    noise = t(noise)
    flips = relu_flips(preacts_j, mt, noise, std)
    metrics_t = trainer_t.train_step(
        cameras_from_jax(cams), t(gt), step, sampling="face", background=t(bg),
        jitter_noise=noise,
    )
    assert int(metrics_t["nonfinite_grads"]) == int(metrics_j["nonfinite_grads"]) == 0
    # loss terms are means over all pixels: cutoff flips move them ~1e-5
    for k in ("loss", "reg"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(metrics_t["splat_psnr"]), float(metrics_j["splat_psnr"]),
                               atol=1e-2)
    for k in ("num_gaussians", "num_surf_cubes", "num_surf_edges"):
        assert int(metrics_t[k]) == int(metrics_j[k]), k
    for k in ("pair_fill", "face_fill", "exposure"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-6, err_msg=k)

    groups_j = trainer_j._groups(grads)
    for name, ps in trainer_t.param_groups().items():
        leaves_j = jax.tree_util.tree_leaves(groups_j[name])
        assert len(leaves_j) == len(ps), name
        for i, (gj, p) in enumerate(zip(leaves_j, ps)):
            g = n(p.grad) / (64.0 if name == "light" else 1.0)  # undo the x64 hook
            gj = np.asarray(gj)
            if name in flips and i == 0:  # first layer [hidden, in]
                keep = ~flips[name]
                assert keep.sum() >= keep.size - 2, (name, np.flatnonzero(~keep))
                g, gj = g[keep], gj[keep]
            close_grads(name, g, gj)


def test_optimizer_matches_optax():
    mj, params, _ = setup()
    trainer_j = JTrainer(JConfig(), mj)
    groups = trainer_j._groups(params)
    opt_state = jax.jit(trainer_j.optimizers.init)(groups)
    update = jax.jit(trainer_j.optimizers.update)
    mt = torch_model(jax.tree.map(np.asarray, params))
    trainer_t = GeoSplatTrainer(GeoSplatTrainerConfig(), mt)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g_np = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), groups)
        groups, opt_state = update(g_np, opt_state, groups)
        for name, ps in trainer_t.param_groups().items():
            for gj, p in zip(jax.tree_util.tree_leaves(g_np[name]), ps):
                p.grad = t(gj)
        trainer_t.optimizers.step()
    for name, ps in trainer_t.param_groups().items():
        for pj, p in zip(jax.tree_util.tree_leaves(groups[name]), ps):
            np.testing.assert_allclose(n(p), np.asarray(pj), rtol=1e-5, atol=1e-6, err_msg=name)


def test_schedule_and_ramps_match_jax():
    from geosplatting_tpu.train.optim import make_schedule as jsched

    from geosplatting_tpu_torch.train.optim import make_schedule

    for kw in (dict(lr_decay=800), dict(lr_decay=100), dict()):
        sj, st = jsched(1e-2, **kw), make_schedule(1e-2, **kw)
        for step in (0, 5, 10, 57, 400):
            np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6)
    mj, params, _ = setup()
    tj = JTrainer(JConfig(), mj)
    tt = GeoSplatTrainer(GeoSplatTrainerConfig(), torch_model(jax.tree.map(np.asarray, params)))
    for step in (0.0, 120.0, 800.0):
        rw_j = tj.reg_weights(jnp.asarray(step, jnp.float32))
        rw_t = tt.reg_weights(step)
        for k, v in rw_t.items():
            np.testing.assert_allclose(v, float(rw_j[k]), rtol=1e-6, err_msg=k)
