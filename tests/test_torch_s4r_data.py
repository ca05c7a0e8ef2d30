"""Port parity: the HDR side of data/io and the Syn4Relight layout against
the JAX package on the CPU: Radiance HDR written and read by either package,
the EXR refusal where this OpenCV has no EXR codec, and
``Syn4RelightDataparser`` (cameras, image stacks with the HDR frames
sRGB-encoded under their masks, the test split's meta paths) and the
dataset's splits on a tiny scene written by ``chip_smoke.write_s4r_scene``.

Tolerances: none. Both packages decode through the same OpenCV and Pillow,
so every array is compared for equality."""
import numpy as np
import pytest

from chip_smoke import S4R_ALBEDO, write_s4r_scene
from geosplatting_tpu.data import io as jio
from geosplatting_tpu.data.dataparsers.blender_family import (
    Syn4RelightDataparser as JSyn4Relight,
)
from geosplatting_tpu.data.dataset import Dataset as JDataset
from geosplatting_tpu_torch.data import io as tio
from geosplatting_tpu_torch.data.dataparsers.blender_family import Syn4RelightDataparser
from geosplatting_tpu_torch.data.dataset import Dataset, recognize_dataparser

from .torch_parity import n, one_torch_thread  # noqa: F401

RES = 32
SF = RES / 800.0
COUNTS = {"train": 3, "test": 2}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("s4r") / "scene"
    write_s4r_scene(root, COUNTS, RES, "cpu")
    return root


def test_hdr_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for channels in (3, 1):
        img = (rng.uniform(size=(7, 9, channels)) * 4).astype(np.float32)
        tio.dump_float32_image(tmp_path / "t.hdr", img)
        jio.dump_float32_image(tmp_path / "j.hdr", img)
        got, want = tio.load_float32_image(tmp_path / "t.hdr"), jio.load_float32_image(
            tmp_path / "t.hdr")
        assert got.dtype == np.float32 and got.shape == (7, 9, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tio.load_float32_image(tmp_path / "j.hdr"), want)
        # RGBE keeps 8 bits of mantissa under a shared exponent: each value to
        # 1/128 of its pixel's largest channel, so the channel order survives
        err = np.abs(got - np.broadcast_to(img, got.shape))
        assert (err <= img.max(-1, keepdims=True) / 128).all()
    with pytest.raises(FileNotFoundError):
        tio.load_float32_image(tmp_path / "missing.hdr")


def test_exr_decodes_or_raises_naming_the_flag(tmp_path):
    import cv2

    img = np.random.default_rng(1).uniform(size=(5, 6, 3)).astype(np.float32)
    try:
        has_exr = bool(cv2.imwrite(str(tmp_path / "probe.exr"), img))
    except cv2.error:
        has_exr = False
    if has_exr:
        tio.dump_float32_image(tmp_path / "t.exr", img)
        np.testing.assert_array_equal(tio.load_float32_image(tmp_path / "t.exr"),
                                      jio.load_float32_image(tmp_path / "t.exr"))
        return
    with pytest.raises(ValueError, match="OPENCV_IO_ENABLE_OPENEXR"):
        tio.dump_float32_image(tmp_path / "t.exr", img)
    (tmp_path / "bad.exr").write_bytes(b"not an exr")
    with pytest.raises(ValueError, match="OPENCV_IO_ENABLE_OPENEXR"):
        tio.load_float32_image(tmp_path / "bad.exr")


def test_syn4relight_parser_matches_jax(scene):
    assert isinstance(recognize_dataparser(scene), Syn4RelightDataparser)
    assert JSyn4Relight.recognize(scene) and Syn4RelightDataparser.recognize(scene)
    for split in ("train", "val", "test"):
        pj = JSyn4Relight().parse(scene, split)
        pt = Syn4RelightDataparser().parse(scene, split)
        np.testing.assert_array_equal(pt.c2w, pj.c2w)
        assert (pt.focal, pt.width, pt.height, pt.near, pt.far, pt.hdr_to_srgb) == (
            pj.focal, pj.width, pj.height, pj.near, pj.far, pj.hdr_to_srgb)
        assert pt.image_paths == pj.image_paths and pt.mask_paths == pj.mask_paths
        assert pt.meta == pj.meta
        np.testing.assert_array_equal(pt.load_images(SF), pj.load_images(SF))
    meta = Syn4RelightDataparser().parse(scene, "test").meta
    assert meta["envmaps"]["envmap6"].name == "envmap6.hdr"
    assert all(p.exists() for p in meta["albedo"] + meta["roughness"]
               + meta["relight"]["envmap6"] + meta["relight"]["envmap12"])


def test_dataset_splits_match_jax(scene):
    dj = JDataset(scene, scale_factor=SF)
    dt = Dataset(scene, scale_factor=SF, device="cpu")
    for split in ("train", "test"):
        cj, ij, mj = dj.get_split(split)
        ct, it, mt = dt.get_split(split)
        for f in ("c2w", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(n(getattr(ct, f)), np.asarray(getattr(cj, f)), f)
        assert (ct.width, ct.height, ct.near, ct.far) == (cj.width, cj.height, cj.near, cj.far)
        np.testing.assert_array_equal(it, ij)
        assert mt == mj
    # the closed-form scene: sRGB-encoded albedo x radiance inside the mask
    _, train, _ = dt.get_split("train")
    inside = train[..., 3] == 1
    assert inside.any() and train[..., 3].min() == 0
    lin = np.asarray(S4R_ALBEDO, np.float32)
    want = np.where(lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1 / 2.4) - 0.055)
    np.testing.assert_allclose(train[inside][:, :3], np.broadcast_to(want, (inside.sum(), 3)),
                               atol=2 / 255)
    # the camera looks at the sphere: the parsed orbit has radius 2
    np.testing.assert_allclose(np.linalg.norm(n(dt.get_split("test")[0].c2w[:, :, 3]), axis=-1),
                               2.0, rtol=1e-5)
