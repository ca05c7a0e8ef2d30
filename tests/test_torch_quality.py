"""Port parity: the quality benchmark's analytic scene against the JAX
package on the CPU, and the port's three-stage chain at the JAX package's
tiny shape held to the JAX package's floors (``tests/test_quality.py``).

Tolerances: the scene's closed forms (ray hits, albedo, shadow rays, the
environments, the cameras, the material maps) agree to 1e-5; the ground-
truth renders through ``env_shade``, with the JAX package's draws replayed
(``fold_in(key, i)`` per view through ``env_shade``'s key splits,
``tests/torch_parity.py``), to ``tests/test_torch_envshade.py``'s
tolerance for sums over the samples, rtol 1e-4 (atol 1e-6), except on the
glossy sphere, where float32 itself holds no better than ~1e-3 (the
test's docstring). The chain's
random streams are the port's own (the two packages' generators differ),
so it is held to the floors, not to the JAX numbers; it runs at the JAX
test's shape but with a 32-texel material triplane, so the floors hold
here at a reduced triplane (512 in the JAX test: on one CPU thread a
stage-1 step then takes ~2.7 s, most of it the triplane's Adam update), and
with 16 / 4 / 4 of the JAX test's 40 / 12 / 8 steps a stage, which keep the
file inside the suite's per-file budget and still clear every floor by
more than 6 dB. ``chip_smoke.py`` holds the JAX shape and steps, triplane
512, to the same floors on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.bench import quality as jq
from geosplatting_tpu_torch.bench import quality as q

from .torch_parity import cameras_from_jax, jax_shade_draws, n, one_torch_thread  # noqa: F401
from .torch_parity import shade_draws, t

RES = 32


def rays(rng, num):
    """Rays from a shell around the scene toward points near its centre."""
    d = rng.standard_normal((num, 3))
    o = 2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    target = rng.uniform(-0.5, 0.5, (num, 3))
    dirs = target - o
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return o.astype(np.float32), dirs.astype(np.float32)


def test_scene_closed_forms_match_jax():
    o, d = rays(np.random.default_rng(0), 4096)
    hit_j, pos_j, nrm_j, obj_j = jq.scene_hit(jnp.asarray(o), jnp.asarray(d))
    hit_t, pos_t, nrm_t, obj_t = q.scene_hit(t(o), t(d))
    np.testing.assert_array_equal(n(hit_t), np.asarray(hit_j))
    np.testing.assert_array_equal(n(obj_t), np.asarray(obj_j))
    assert 0.3 < float(n(hit_t).mean()) < 0.9 and n(obj_t).any()
    np.testing.assert_allclose(n(pos_t), np.asarray(pos_j), atol=1e-5)
    np.testing.assert_allclose(n(nrm_t), np.asarray(nrm_j), atol=1e-5)
    np.testing.assert_allclose(n(q.scene_kd(pos_t, obj_t)),
                               np.asarray(jq.scene_kd(pos_j, obj_j)), atol=1e-5)
    np.testing.assert_array_equal(n(q.scene_roughness(obj_t)),
                                  np.asarray(jq.scene_roughness(obj_j)))
    # shadow rays from the surface points along random directions
    s = np.random.default_rng(1).standard_normal(d.shape).astype(np.float32)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    origins = n(pos_t) + n(nrm_t) * 1e-3
    v_t = n(q.visibility(t(origins), t(s)))
    np.testing.assert_array_equal(v_t, np.asarray(jq.visibility(jnp.asarray(origins),
                                                                jnp.asarray(s))))
    assert 0.0 < v_t.mean() < 1.0
    for kind in ("train", "relight"):
        np.testing.assert_allclose(n(q.make_envmap(kind=kind, device="cpu")),
                                   np.asarray(jq.make_envmap(kind=kind)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        q.make_envmap(kind="studio", device="cpu")


@pytest.mark.parametrize("kind, num", [("train", 10), ("test", 2), ("train", 3)])
def test_cameras_and_material_maps_match_jax(kind, num):
    cj = jq.make_cameras(kind, num, width=RES, height=RES)
    ct = q.make_cameras(kind, num, width=RES, height=RES, device="cpu")
    assert ct.shape == tuple(cj.shape) and (ct.width, ct.height) == (RES, RES)
    for f in ("c2w", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(n(getattr(ct, f)), np.asarray(getattr(cj, f)), atol=1e-5,
                                   err_msg=f)
    if kind == "test":
        alb_j, rough_j = jq.gt_material_maps(cj)
        alb_t, rough_t = q.gt_material_maps(cameras_from_jax(cj))
        np.testing.assert_allclose(n(alb_t), np.asarray(alb_j), atol=1e-5)
        np.testing.assert_allclose(n(rough_t), np.asarray(rough_j), atol=1e-5)
        assert 0.1 < float(rough_t[..., 1].mean()) < 0.9


def test_gt_views_match_jax_with_its_draws():
    """Matte sphere A and the background to rtol 1e-4; the glossy sphere B
    (roughness 0.18, alpha^2 ~ 1e-3) to rtol 2e-3: its GGX lobe magnifies
    float32 rounding, so that the port's own float32 render of this view
    differs from its float64 render by up to 1.1e-3 there (on a CPU)."""
    spp_x = 2
    cj = jq.make_cameras("test", 2, width=RES, height=RES)
    ct = cameras_from_jax(cj)
    key = jax.random.key(8)
    draws = [shade_draws(jax_shade_draws(jax.random.fold_in(key, i), RES * RES, spp_x))
             for i in range(2)]
    glossy = np.stack([np.asarray(jq.scene_hit(*(r.reshape(-1, 3) for r in cj[i].generate_rays()))
                                  [3]).reshape(RES, RES) == 1 for i in range(2)])
    assert 0 < glossy.sum() < glossy.size // 4
    for kind, shadows in (("train", True), ("relight", False)):
        env = jq.make_envmap(kind=kind)
        want = np.asarray(jq.render_gt_views(cj, env, key, spp_x, shadows=shadows))
        got = n(q.render_gt_views(ct, t(env), spp_x=spp_x, shadows=shadows, draws=draws))
        assert got.shape == (2, RES, RES, 4)
        np.testing.assert_allclose(got[~glossy], want[~glossy], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[glossy], want[glossy], rtol=2e-3, atol=1e-6)
        np.testing.assert_array_equal(got[..., 3], want[..., 3])
        assert 0.02 < got[..., :3].mean() < 0.9


def test_gt_views_draw_from_a_generator():
    cams = q.make_cameras("test", 1, width=16, height=16, device="cpu")
    env = q.make_envmap(device="cpu")
    a = q.render_gt_views(cams, env, torch.Generator().manual_seed(3), spp_x=2)
    b = q.render_gt_views(cams, env, torch.Generator().manual_seed(3), spp_x=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    alpha = a[..., 3]
    assert set(np.unique(n(alpha))) <= {0.0, 1.0} and torch.isfinite(a).all()
    assert bool((a[..., :3] <= alpha[..., None] + 1e-7).all())   # premultiplied


@pytest.fixture(scope="module")
def tiny_chain():
    from geosplatting_tpu_torch.bench.quality_chain import run_quality_chain

    stages = {}
    r = run_quality_chain(
        img_res=RES, grid_res=10, n_train=10, n_test=2, batch=2,
        s1_steps=16, s2_steps=4, s3_steps=4, gt_spp_x=6, train_spp_x=2,
        light_resolution=32, seed=0,
        triplane_resolution=32, device="cpu",
        on_stage=lambda name, numbers: stages.update({name: numbers}))
    return r, stages


def test_tiny_chain_reaches_the_jax_floors(tiny_chain):
    r, stages = tiny_chain
    # the floors of tests/test_quality.py:52-58
    assert r["nvs_psnr"] > 14.0, r
    assert r["relight_psnr"] > 12.0, r
    assert r["albedo_psnr"] > 15.0, r
    assert r["roughness_mse"] < 0.5, r
    assert r["s1_train_psnr"] > 14.0, r
    assert list(stages) == ["s1", "s2", "s3"]
    for s in ("s1", "s2", "s3"):
        assert r[f"s{s[1]}_nonfinite_grads"] == 0 and np.isfinite(r[f"{s}_loss"])
        fills = [v for k, v in r.items() if k.startswith(f"{s}_") and k.endswith("_fill")]
        assert fills and max(fills) <= 1.0, r
    assert {"s3_mesh_tile_fill", "s3_mesh_pair_fill", "s2_face_fill"} <= set(r)
    assert len(r["albedo_scaling"]) == 3


def test_tiny_chain_roughness_readouts(tiny_chain):
    """``roughness_mse_channel0`` is the JAX function's readout (channel 0 of
    the ks map, a constant 0): the masked mean of the ground truth's squared
    roughness, computed here from the JAX package's own maps."""
    r, _ = tiny_chain
    _, rough = jq.gt_material_maps(jq.make_cameras("test", 2, width=RES, height=RES))
    rough = np.asarray(rough)
    want = np.mean([(rough[i, ..., 0] ** 2 * (rough[i, ..., 1] > 0.5)).sum()
                    / max((rough[i, ..., 1] > 0.5).sum(), 1) for i in range(2)])
    np.testing.assert_allclose(r["roughness_mse_channel0"], want, rtol=1e-5)
    assert r["roughness_mse"] < r["roughness_mse_channel0"]
