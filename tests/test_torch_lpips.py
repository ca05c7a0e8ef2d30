"""Port parity: LPIPS (``ops/lpips.py``) and its place in ``image_metrics``
against the JAX package, with seeded random VGG16 + lin weights written to
an ``.npz`` as tests/test_lpips.py writes them (nothing is downloaded).

Tolerances: LPIPS rtol 1e-5 (float32 convolutions summed in another order);
the PSNR and SSIM beside it as tests/test_torch_eval.py holds them."""
import numpy as np
import pytest

from geosplatting_tpu.engine import eval_tasks as jeval
from geosplatting_tpu.ops import lpips as jlpips
from geosplatting_tpu_torch.engine import eval_tasks as teval
from geosplatting_tpu_torch.ops import lpips as tlpips

from .test_lpips import _fixture_weights
from .torch_parity import one_torch_thread, t  # noqa: F401


@pytest.fixture
def weights_file(tmp_path, monkeypatch):
    path = tmp_path / "lpips_fixture.npz"
    np.savez(path, **_fixture_weights())
    monkeypatch.setenv("GEOSPLAT_LPIPS_WEIGHTS", str(path))
    jlpips._load_weights.cache_clear()
    yield path
    jlpips._load_weights.cache_clear()


def images(seed=3, shape=(17, 19, 3)):
    """An image and a noisy copy; odd sizes, so every 2x2 pool rounds down
    as a VALID window does (17 x 19 -> 8 x 9 -> 4 x 4 -> 2 x 2 -> 1 x 1)."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, size=shape).astype(np.float32)
    return pred, np.clip(pred + rng.normal(0, 0.1, shape).astype(np.float32), 0, 1)


def test_lpips_matches_jax(weights_file):
    import jax.numpy as jnp

    pred, target = images()
    got = tlpips.lpips(t(pred), t(target))
    assert got > 0.0
    np.testing.assert_allclose(got, jlpips.lpips(jnp.asarray(pred), jnp.asarray(target)),
                               rtol=1e-5)
    assert tlpips.lpips(t(pred), t(pred)) == pytest.approx(0.0, abs=1e-7)
    # a batch is the mean of its images' distances
    both = tlpips.lpips(t(np.stack((pred, target))), t(np.stack((target, target))))
    np.testing.assert_allclose(both, got / 2, rtol=1e-5)


def test_image_metrics_report_lpips_as_jax_does(weights_file, monkeypatch, capsys):
    pred, target = images(seed=4)
    got = teval.image_metrics(pred, target)
    want = jeval.image_metrics(pred, target)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=1e-5)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    assert "lpips" not in teval.image_metrics(pred, target, fast=True)
    # unset, or naming no file: lpips is None, with a message that says which
    for value in (None, str(weights_file.parent / "missing.npz")):
        if value is None:
            monkeypatch.delenv("GEOSPLAT_LPIPS_WEIGHTS")
        else:
            monkeypatch.setenv("GEOSPLAT_LPIPS_WEIGHTS", value)
        monkeypatch.setattr(teval, "_LPIPS_WARNED", False)
        assert teval.image_metrics(pred, target)["lpips"] is None
        printed = capsys.readouterr().out
        assert "reporting lpips: null" in printed
        assert ("missing.npz" in printed) == (value is not None)
        with pytest.raises(FileNotFoundError):
            tlpips.lpips(t(pred), t(target))
