"""Port parity: engine/eval_tasks (``image_metrics``,
``estimate_albedo_scaling`` with both methods, ``RelightEvaler``) against
the JAX package on the CPU, on the stage-3 parameters of
tests/test_torch_stage3.py and a 2-view test split at 32x32 with albedo,
roughness, relit frames and a relight environment written to a temporary
directory. The shade draws of the renders are the JAX evaluator's (one key
for every chunk), replayed into the port's ``shade_draws``.

Tolerances: PSNR atol 1e-2 (the stage-2 and stage-3 tests'), SSIM atol
1e-3, the albedo scaling and the roughness MSE rtol 1e-4; image_metrics on
the same images 1e-5."""
import jax
import numpy as np
import pytest
import torch

from geosplatting_tpu.engine import eval_tasks as jev
from geosplatting_tpu.ops import rasterize_pairs as jrp
from geosplatting_tpu_torch.data.io import dump_float32_image, load_masked_image
from geosplatting_tpu_torch.engine import eval_tasks as tev

from .test_torch_stage3 import NSX, make_stage3, torch_model
from .test_torch_trainer import sphere_gt
from .torch_parity import (  # noqa: F401
    cameras_from_jax, jax_defer_draws, one_torch_thread, shade_draws,
)


@pytest.fixture(scope="module", autouse=True)
def jax_pairs_interpret():
    old = jrp._INTERPRET
    jrp._INTERPRET = True
    yield
    jrp._INTERPRET = old


class Split:
    """A dataset stub with only a test split (cameras, images, meta)."""

    scale_factor = None

    def __init__(self, cams, images, meta):
        self.split = (cams, images, meta)

    def get_split(self, name):
        assert name == "test"
        return self.split


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    md, params, geom, cams, export = make_stage3()
    root = tmp_path_factory.mktemp("eval")
    gt = sphere_gt(cams)
    rng = np.random.default_rng(7)
    mask = gt[..., 3:]
    meta = {"albedo": [], "roughness": [], "relight": {"envmap6": []},
            "envmaps": {"envmap6": root / "envmap6.hdr"}}
    for i in range(2):
        for key, value in (("albedo", rng.uniform(0.3, 0.8, 3)), ("roughness", np.full(3, 0.4)),
                           ("relight", rng.uniform(0.2, 0.9, 3))):
            path = root / f"{key}_{i}.png"
            dump_float32_image(path, np.concatenate((value * mask[i], mask[i]), -1))
            (meta["relight"]["envmap6"] if key == "relight" else meta[key]).append(path)
    dump_float32_image(root / "envmap6.hdr",
                       (0.4 + rng.uniform(size=(8, 16, 3))).astype(np.float32))
    mt = torch_model(params, export)
    _, draws = jax_defer_draws(jax.random.key(0), np.shape(params["means"])[0], 32 * 32, 2, NSX)
    return {"jax": (md, params, geom, Split(cams, gt, meta)),
            "port": (mt, Split(cameras_from_jax(cams), gt, meta)),
            "draws": [shade_draws(d) for d in draws]}


def test_image_metrics_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(size=(2, 24, 20, 3)).astype(np.float32)
    got, want = tev.image_metrics(a, b), jev.image_metrics(a, b)
    assert sorted(got) == sorted(want) == ["lpips", "psnr", "ssim"] and got["lpips"] is None
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert tev.image_metrics(a, b, fast=True) == {"psnr": got["psnr"]}
    assert tev._mean_metrics([got, {**got, "psnr": 0.0}])["psnr"] == got["psnr"] / 2


@pytest.mark.parametrize("method", ["least-square", "median"])
def test_albedo_scaling_matches_jax(setup, method):
    md, params, _, split_j = setup["jax"]
    mt, split_t = setup["port"]
    cams_j, _, meta = split_j.get_split("test")
    albedos = np.stack([load_masked_image(p) for p in meta["albedo"]])
    want = jev.estimate_albedo_scaling(md, params, cams_j, albedos, method=method)
    got = tev.estimate_albedo_scaling(mt, split_t.get_split("test")[0], albedos, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert (got > 0.1).all()


def test_relight_evaler_matches_jax(setup):
    md, params, geom, split_j = setup["jax"]
    mt, split_t = setup["port"]
    want = jev.RelightEvaler(model=md, params=params, geometry=geom, fast=False).run(split_j)
    got = tev.RelightEvaler(model=mt, fast=False, shade_draws=setup["draws"]).run(split_t)
    assert sorted(got) == sorted(want) == ["albedo", "albedo_scaling", "nvs", "relight/envmap6",
                                           "roughness_mse"]
    np.testing.assert_allclose(got["albedo_scaling"], want["albedo_scaling"], rtol=1e-4)
    np.testing.assert_allclose(got["roughness_mse"], want["roughness_mse"], rtol=1e-4)
    for k in ("nvs", "relight/envmap6", "albedo"):
        assert got[k]["lpips"] is None and want[k]["lpips"] is None
        np.testing.assert_allclose(got[k]["psnr"], want[k]["psnr"], atol=1e-2, err_msg=k)
        np.testing.assert_allclose(got[k]["ssim"], want[k]["ssim"], atol=1e-3, err_msg=k)
    # the default draws: a generator seeded per chunk gives every render kind the same draws
    again = tev.RelightEvaler(model=mt, skip_mat=True, seed=3)
    with torch.no_grad():
        first, second = again.run(split_t), again.run(split_t)
    assert first == second and np.isfinite(first["nvs"]["psnr"])
