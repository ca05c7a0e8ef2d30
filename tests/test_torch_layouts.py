"""Port parity: the TensoIR, Shiny Blender and DepthBlender layouts against
the JAX package on the CPU, on tiny scenes written here from the Blender
scene of ``torch_scenes.write_sphere_scene`` (nothing is downloaded):
cameras, image paths, near / far, images and meta of every split, and the
layout that recognition picks, in the JAX package's order. Also the suite
scripts that run them, checked by ``bash -n``.

Tolerances: none; both packages decode the same files through Pillow."""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from geosplatting_tpu.data import dataset as jdataset
from geosplatting_tpu.data.dataparsers import blender_family as jbf
from geosplatting_tpu_torch.data import dataset as tdataset
from geosplatting_tpu_torch.data.dataparsers import blender_family as tbf

from .torch_parity import n, one_torch_thread  # noqa: F401
from .torch_scenes import write_sphere_scene

ROOT = Path(__file__).resolve().parents[1]
RES = 16
SF = RES / 800.0
COUNTS = {"train": 3, "val": 2, "test": 2}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("layouts")
    write_sphere_scene(base / "blender", COUNTS, RES, "cpu")
    # TensoIR: the same poses, frames stored as <file_path>_sunset.png
    shutil.copytree(base / "blender", base / "tensoir")
    for png in (base / "tensoir").rglob("r_*.png"):
        png.rename(png.with_name(png.stem + "_sunset.png"))
    # Shiny Blender: no val split
    shutil.copytree(base / "blender", base / "shiny")
    (base / "shiny" / "transforms_val.json").unlink()
    shutil.rmtree(base / "shiny" / "val")
    return base


CASES = [("tensoir", "TensoIRDataparser", ("train", "val", "test")),
         ("shiny", "ShinyBlenderDataparser", ("train", "val", "test")),
         ("blender", "DepthBlenderDataparser", ("train", "test"))]


@pytest.mark.parametrize("layout, parser, splits", CASES)
def test_parser_matches_jax(scenes, layout, parser, splits):
    path = scenes / layout
    pj, pt = getattr(jbf, parser)(), getattr(tbf, parser)()
    for split in splits:
        sj, st = pj.parse(path, split), pt.parse(path, split)
        np.testing.assert_array_equal(st.c2w, sj.c2w)
        assert (st.focal, st.width, st.height, st.near, st.far) == (
            sj.focal, sj.width, sj.height, sj.near, sj.far)
        assert st.image_paths == sj.image_paths and st.meta == sj.meta
        np.testing.assert_array_equal(st.load_images(SF), sj.load_images(SF))
        # the port's dataset on that parser: cameras and images as JAX's
        dj = jdataset.Dataset(path, scale_factor=SF, dataparser=pj)
        dt = tdataset.Dataset(path, scale_factor=SF, dataparser=pt, device="cpu")
        (cj, ij, _), (ct, it, _) = dj.get_split(split), dt.get_split(split)
        np.testing.assert_array_equal(n(ct.c2w), np.asarray(cj.c2w))
        np.testing.assert_array_equal(n(ct.fx), np.asarray(cj.fx))
        np.testing.assert_array_equal(it, ij)
    if parser == "DepthBlenderDataparser":
        imgs = pt.parse(path, "train").load_images()
        assert imgs.shape[-1] == 2 and imgs[..., 0].max() > 1.0   # depth = red x 4


def test_recognition_picks_the_jax_layout(scenes, tmp_path):
    for layout, want in (("blender", "BlenderDataparser"), ("tensoir", "TensoIRDataparser"),
                         ("shiny", "ShinyBlenderDataparser")):
        got_j = type(jdataset.recognize_dataparser(scenes / layout)).__name__
        got_t = type(tdataset.recognize_dataparser(scenes / layout)).__name__
        assert got_t == got_j == want, layout
    # a Blender scene with the Syn4Relight environments beside it is neither
    # Shiny nor Blender to either package once it lacks the val split
    s4r_like = tmp_path / "scenes" / "shiny"
    shutil.copytree(scenes / "shiny", s4r_like)
    (s4r_like.parent / "envmap6.exr").write_bytes(b"")
    with pytest.raises(ValueError, match="no dataparser"):
        jdataset.recognize_dataparser(s4r_like)
    with pytest.raises(ValueError, match="no dataparser"):
        tdataset.recognize_dataparser(s4r_like)


@pytest.mark.parametrize("script, suite, scenes_of", [
    ("eval_torch_s4r.sh", "eval_s4r.sh", "s4r"),
    ("eval_torch_tsir.sh", "eval_tsir.sh", "tsir"),
    ("eval_torch_sb.sh", "eval_sb.sh", "sb"),
])
def test_suite_scripts(script, suite, scenes_of):
    """Each port suite parses, and runs the scenes, presets and evaluation
    of its JAX counterpart through the port's CLIs."""
    subprocess.run(["bash", "-n", str(ROOT / script)], check=True)
    text, ref = (ROOT / script).read_text(), (ROOT / suite).read_text()
    scene_line = next(ln for ln in ref.splitlines() if ln.startswith("for scene in"))
    assert scene_line in text
    for cmd in ("train_geosplat ", "train_geosplat_mc ", "train_geosplat_defer "):
        assert f"geosplatting_tpu_torch.scripts.{cmd}\"{scenes_of}-$scene\"" in text
    evaluation = "reliteval" if "reliteval" in ref else "nvseval"
    assert f"train_geosplat_defer {evaluation} " in text
    assert ("--skip_nvs true" in text) == ("--skip_nvs true" in ref)
    assert "export OPENCV_IO_ENABLE_OPENEXR" in text and "scripts/train_" not in text
    from geosplatting_tpu_torch.scripts import train_geosplat, train_geosplat_defer
    from geosplatting_tpu_torch.scripts import train_geosplat_mc

    for scene in scene_line.split(";")[0].split()[3:]:
        for cli in (train_geosplat, train_geosplat_mc, train_geosplat_defer):
            assert f"{scenes_of}-{scene}" in cli.TASKS, (cli.__name__, scene)
