"""Port parity: data/io (PNG load, masked load, dump, bilinear resize)
against Pillow and the JAX package's data/io. Decoding is bit-exact (the
same Pillow decode, the same scaling); the resize is Pillow's own, so it
equals the JAX package's exactly and Pillow's float resize to 1/255."""
import numpy as np
import pytest
from PIL import Image

from geosplatting_tpu.data import io as jio
from geosplatting_tpu_torch.data import io as tio

from .torch_parity import one_torch_thread  # noqa: F401


def random_image(mode, shape, bits, seed):
    rng = np.random.default_rng(seed)
    top = 255 if bits == 8 else 65535
    arr = rng.integers(0, top + 1, size=shape).astype(np.uint8 if bits == 8 else np.uint16)
    img = Image.fromarray(arr)
    assert img.mode == mode
    return img, arr, top


@pytest.mark.parametrize("mode,shape,bits", [
    ("L", (13, 17), 8), ("RGB", (13, 17, 3), 8), ("RGBA", (13, 17, 4), 8),
    ("I;16", (13, 17), 16),
])
def test_load_float32_image_matches_pillow_and_jax(tmp_path, mode, shape, bits):
    img, arr, top = random_image(mode, shape, bits, seed=len(shape) + bits)
    path = tmp_path / "x.png"
    img.save(path)
    got = tio.load_float32_image(path)
    want = arr.astype(np.float32) / top
    if want.ndim == 2:
        want = want[..., None]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jio.load_float32_image(path))


def test_masked_load_and_dump_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(9, 11, 3)).astype(np.float32)
    mask = rng.uniform(size=(9, 11, 1)).astype(np.float32)
    tio.dump_float32_image(tmp_path / "t_rgb.png", rgb)
    tio.dump_float32_image(tmp_path / "t_mask.png", mask)
    jio.dump_float32_image(tmp_path / "j_rgb.png", rgb)
    # the two packages write the same bytes' worth of pixels
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t_rgb.png")),
                                  np.asarray(Image.open(tmp_path / "j_rgb.png")))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t_rgb.png")),
                                  (rgb * 255.0).round().astype(np.uint8))
    for mask_path in (tmp_path / "t_mask.png", None):
        got = tio.load_masked_image(tmp_path / "t_rgb.png", mask_path)
        want = jio.load_masked_image(tmp_path / "t_rgb.png", mask_path)
        assert got.shape == (9, 11, 4)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.04, 0.5, 0.37, 1.5])
@pytest.mark.parametrize("channels", [3, 4])
def test_resize_image_matches_pillow_bilinear(scale, channels):
    img = np.random.default_rng(4).uniform(size=(50, 40, channels)).astype(np.float32)
    got = tio.resize_image(img, scale)
    np.testing.assert_array_equal(got, jio.resize_image(img, scale))
    nh, nw = int(50 * scale), int(40 * scale)
    assert got.shape == (nh, nw, channels)
    if channels == 4:
        return  # Pillow resizes RGBA premultiplied by alpha, as the JAX package does
    # Pillow's float bilinear resize of each channel of the same 8-bit
    # input: the 8-bit path rounds its output to 1/255
    q = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
    ref = np.stack([np.asarray(Image.fromarray(q[..., c]).resize((nw, nh), Image.BILINEAR))
                    for c in range(channels)], -1)
    assert np.abs(got - ref).max() <= 1.0 / 255 + 1e-6  # 1/255 in f32


def test_hdr_formats_are_refused(tmp_path):
    """HDR files cv2 cannot decode, and formats neither reader knows, raise
    (the HDR round trip itself is in tests/test_torch_s4r_data.py)."""
    (tmp_path / "x.hdr").write_bytes(b"not a radiance file")
    with pytest.raises(ValueError, match="HDR"):
        tio.load_float32_image(tmp_path / "x.hdr")
    with pytest.raises(FileNotFoundError):
        tio.load_float32_image(tmp_path / "missing.exr")
    with pytest.raises(ValueError, match="unsupported"):
        tio.load_float32_image(tmp_path / "x.pfm")
    with pytest.raises(ValueError, match="unsupported"):
        tio.dump_float32_image(tmp_path / "x.pfm", np.zeros((2, 2, 3), np.float32))
