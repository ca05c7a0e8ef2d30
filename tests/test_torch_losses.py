"""Port parity: the loss library, chamfer / F-score and the splat PLY IO
against the JAX package on the CPU.

Tolerances: the losses rtol 1e-5; chamfer rtol 1e-5 (the same expansion in
chunks of 4096 rows, N != M, N not a multiple of 4096); the F-score rtol
1e-6, its thresholds kept off the distances so that both count the same
points (one point more or less moves it by > 1e-4); the PLY files byte for
byte both ways."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics import splats_io as jio
from geosplatting_tpu.graphics.splats import Splats as JSplats
from geosplatting_tpu.train import losses as jl
from geosplatting_tpu_torch.convert import splats_from_numpy, splats_to_numpy
from geosplatting_tpu_torch.graphics import splats_io as tio
from geosplatting_tpu_torch.train import losses as tl

from .torch_parity import n, one_torch_thread, t  # noqa: F401


def images(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.1, 1.5, (2, 24, 20, 3)).astype(np.float32)
    target = rng.uniform(0, 2.0, (2, 24, 20, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 24, 20, 1)) > 0.4).astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("name", ["l1", "l2", "psnr", "masked_l1", "hdr_l1", "ssim",
                                  "ssim_l1_loss"])
def test_losses_match_jax(name):
    pred, target, mask = images()
    args = (pred, target, mask) if name == "masked_l1" else (pred, target)
    if name.startswith("ssim"):
        args = (np.clip(pred, 0, 1), np.clip(target, 0, 1) / 2)
    kws = ({}, {"max_val": 2.0}) if name == "psnr" else ({},)
    for kw in kws:
        got = getattr(tl, name)(*map(t, args), **kw)
        want = getattr(jl, name)(*map(jnp.asarray, args), **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chamfer_and_f_score_match_jax():
    """N = 5000 (two chunks, the second partial) against M = 3100, and the
    other way round; F-score at thresholds between the distances."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    b = (rng.uniform(-1, 1, (3100, 3)) * 0.9 + 0.05).astype(np.float32)
    for x, y in ((a, b), (b, a)):
        got = tl.chamfer_distance(t(x), t(y))
        want = jl.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        # thresholds in the widest gap between the distances near a quantile,
        # far from the ~1e-6 rounding of the expansion
        sq = ((x[:, None] - y[None]) ** 2).sum(-1)
        d = np.sort(np.sqrt(np.concatenate((sq.min(1), sq.min(0)))))
        for q in (0.3, 0.6):
            i = int(q * len(d))
            j = i + int(np.argmax(np.diff(d[i:i + 64])))
            assert d[j + 1] - d[j] > 2e-5
            th = float(0.5 * (d[j] + d[j + 1]))
            np.testing.assert_allclose(float(tl.f_score(t(x), t(y), th)), float(
                jl.f_score(jnp.asarray(x), jnp.asarray(y), th)), rtol=1e-6)
    sq = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    exact = 0.5 * (np.sqrt(sq.min(1)).mean() + np.sqrt(sq.min(0)).mean())
    np.testing.assert_allclose(float(tl.chamfer_distance(t(a), t(b))), exact, rtol=1e-4)


def splats(sh_k: int, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    num = 257
    return {
        "means": rng.normal(size=(num, 3)).astype(np.float32),
        "scales": rng.normal(-3, 0.5, (num, 3)).astype(np.float32),
        "quats": rng.normal(size=(num, 4)).astype(np.float32),
        "colors": rng.uniform(0, 1, (num, 3)).astype(np.float32),
        "opacities": rng.normal(size=(num, 1)).astype(np.float32),
        "shs": rng.normal(size=(num, sh_k, 3)).astype(np.float32) * 0.1,
    }


@pytest.mark.parametrize("sh_k", [0, 15])
def test_splats_ply_bytes_match_jax(sh_k, tmp_path, monkeypatch):
    """The port writes the JAX writer's bytes; each package reads the
    other's file back to the same Gaussians."""
    p = splats(sh_k)
    tio.export_splats_ply(splats_from_numpy(p), tmp_path / "port.ply")
    jio.export_splats_ply(JSplats(**{k: jnp.asarray(v) for k, v in p.items()}),
                          tmp_path / "jax.ply")
    raw = (tmp_path / "port.ply").read_bytes()
    assert raw == (tmp_path / "jax.ply").read_bytes()
    assert raw.startswith(b"ply\nformat binary_little_endian 1.0\nelement vertex 257\n")
    back_t = splats_to_numpy(tio.import_splats_ply(tmp_path / "jax.ply", device="cpu"))
    back_j = jio.import_splats_ply(tmp_path / "port.ply")
    for k in p:
        np.testing.assert_array_equal(back_t[k], np.asarray(getattr(back_j, k)), err_msg=k)
        assert back_t[k].shape == p[k].shape
    np.testing.assert_allclose(back_t["colors"], p["colors"], atol=1e-6)
    q = p["quats"] / np.linalg.norm(p["quats"], axis=-1, keepdims=True)
    np.testing.assert_allclose(back_t["quats"], q, atol=1e-7)
    for k in ("means", "scales", "opacities", "shs"):
        np.testing.assert_array_equal(back_t[k], p[k])
    # the reader's default device is the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.import_splats_ply(tmp_path / "jax.ply")
