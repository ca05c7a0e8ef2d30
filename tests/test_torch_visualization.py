"""Port parity: the visualization tools, the video writer, the console and
the tasks' ``turntable`` / ``vis_export_every`` / ``dashboard`` options.

The same inputs (numpy, from a seed) go through the JAX package and the
port: the turntable schedule (the same step -> orbit index, each
scheduled camera's c2w to 1e-6), the director's frames, the figure grid and
``highlight_crop`` (pixel-equal), the splat buffer and the viewer page and
the COLMAP page (byte-equal), the console's charts (equal strings). The
video writer's GIF and its PNG-sequence fallback, the dashboard (and its
ImportError naming ``rich`` without it), and two tasks that write their
turntable frames and HTML snapshots run on the port alone."""
import base64
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geosplatting_tpu.data.io import open_video_renderer as j_open_video_renderer
from geosplatting_tpu.visualization import director as jdirector
from geosplatting_tpu.visualization import figures as jfigures
from geosplatting_tpu.visualization import viewer_html as jviewer
from geosplatting_tpu.visualization.turntable import OptimizationVisualizer as JViz
from geosplatting_tpu_torch.data.io import open_video_renderer
from geosplatting_tpu_torch.graphics.splats import Splats
from geosplatting_tpu_torch.visualization import director as tdirector
from geosplatting_tpu_torch.visualization import figures as tfigures
from geosplatting_tpu_torch.visualization import viewer_html as tviewer
from geosplatting_tpu_torch.visualization.turntable import OptimizationVisualizer

from .torch_parity import n, one_torch_thread  # noqa: F401

# the modules, not the packages' ``console`` objects of the same name
jconsole = importlib.import_module("geosplatting_tpu.ui.console")
tconsole = importlib.import_module("geosplatting_tpu_torch.ui.console")


@pytest.mark.parametrize("kw", [
    dict(spin_resolution=256, resolution=(32, 32), num_ease_in_step=20, num_spins=1.0,
         num_frames_per_spin=10),
    dict(up="+y", pitch_degree=15.0, radius=2.5, fov_degrees=50.0, frame_begin=7),
])
def test_turntable_schedule_matches_jax(kw):
    kw = {"up": "+z", **kw}
    jviz, tviz = JViz(**kw), OptimizationVisualizer(**kw, device="cpu")
    jviz.setup(num_steps=120)
    tviz.setup(num_steps=120)
    assert tviz._sequence == jviz._sequence and len(tviz._sequence) > 5
    for step in range(1, 121):
        jc, tc = jviz.get_camera(step), tviz.get_camera(step)
        assert (jc is None) == (tc is None), step
        if tc is not None:
            assert tc.shape == (1,) and (tc.width, tc.height) == tviz.resolution
            np.testing.assert_allclose(n(tc.c2w[0]), np.asarray(jc.c2w), atol=1e-6)
            np.testing.assert_allclose(n(tc.fx[0]), np.asarray(jc.fx), rtol=1e-6)
    off = OptimizationVisualizer(up="disable", device="cpu")
    off.setup(10)
    assert off.get_camera(1) is None


def _layout(mod, frames):
    return mod.Grid(children=[
        [mod.Fade(mod.Leaf(frames), duration=2),
         mod.Static((0.2, 0.4, 0.6))],
        [mod.Highlight(mod.Leaf(frames), crop=(0.2, 0.2, 0.6, 0.6)),
         mod.Fade(mod.Text("hi"), duration=3, mode="out")],
        [mod.Leaf(frames, hold=False), mod.Static(frames[0]), None],
    ], cell=(48, 40), gap=2)


def test_director_frames_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.uniform(size=(24, 30, 3)).astype(np.float32) for _ in range(4)]
    want = list(jdirector.Director(_layout(jdirector, frames), fps=4).frames())
    got = list(tdirector.Director(_layout(tdirector, frames), fps=4).frames())
    # frames handed over as tensors draw the same pixels
    got_t = list(tdirector.Director(_layout(tdirector, [torch.from_numpy(f) for f in frames]),
                                    fps=4).frames())
    assert len(got) == len(want) == 4
    for a, b, c in zip(got, want, got_t):
        assert a.shape == (3 * 40 + 4 * 2, 3 * 48 + 4 * 2, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert got[0][2:42, 2:50].min() > 0.9          # the fade-in starts at white
    np.testing.assert_array_equal(
        tdirector.Grid([[tdirector.Leaf(frames)]], cell=(30, 24)).render_frame(1, (20, 16)),
        jdirector.Grid([[jdirector.Leaf(frames)]], cell=(30, 24)).render_frame(1, (20, 16)))
    tdirector.Director(_layout(tdirector, frames), fps=4).write(tmp_path / "anim.gif")
    j_path = tmp_path / "j" / "anim.gif"
    jdirector.Director(_layout(jdirector, frames), fps=4).write(j_path)
    assert (tmp_path / "anim.gif").read_bytes() == j_path.read_bytes()


def test_figures_and_highlight_crop_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(32, 36, 3)).astype(np.float32)
    img2 = rng.uniform(size=(20, 20, 4)).astype(np.float32)
    rows = {"ours": {"a": img, "b": img2}, "ref": {"a": img2, "c": img}}
    for kw in (dict(cell=(40, 30), crop=(0.25, 0.25, 0.75, 0.75)),
               dict(cell=(40, 40), crop=(0.1, 0.2, 0.5, 0.9), zoom_row=False), dict()):
        np.testing.assert_array_equal(tfigures.TabularFigures(rows=rows, **kw).render(),
                                      jfigures.TabularFigures(rows=rows, **kw).render())
    tfigures.TabularFigures(rows=rows, cell=(40, 30)).save(tmp_path / "fig.png")
    jfigures.TabularFigures(rows=rows, cell=(40, 30)).save(tmp_path / "jfig.png")
    assert (tmp_path / "fig.png").read_bytes() == (tmp_path / "jfig.png").read_bytes()
    for crop in ((0.0, 0.0, 0.5, 0.5), (0.3, 0.1, 0.9, 0.6)):
        marked, region = tfigures.highlight_crop(torch.from_numpy(img), crop, border=3)
        jmarked, jregion = jfigures.highlight_crop(img, crop, border=3)
        np.testing.assert_array_equal(marked, jmarked)
        np.testing.assert_array_equal(region, jregion)
    assert marked[6, 10, 0] == np.float32(1.0)      # the border is drawn


def _splat_arrays(rng, num):
    q = rng.standard_normal((num, 4)).astype(np.float32)
    return {"means": rng.uniform(-1, 1, (num, 3)).astype(np.float32),
            "scales": rng.uniform(-5, -2, (num, 3)).astype(np.float32),
            "quats": q, "opacities": rng.standard_normal((num, 1)).astype(np.float32) * 2,
            "colors": rng.uniform(-0.2, 1.2, (num, 3)).astype(np.float32)}


def test_splat_buffer_and_viewer_page_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    arrays = _splat_arrays(rng, 64)
    lin = (arrays["means"], np.exp(arrays["scales"]), arrays["quats"],
           rng.uniform(-0.1, 1.1, 64).astype(np.float32), arrays["colors"])
    assert tviewer.splats_to_buffer(*lin) == jviewer.splats_to_buffer(*lin)
    want = jviewer.vis_3dgs(arrays, tmp_path / "jax.html").read_bytes()
    assert tviewer.vis_3dgs(arrays, tmp_path / "np.html").read_bytes() == want
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert tviewer.vis_3dgs(tensors, tmp_path / "t.html").read_bytes() == want
    splats = Splats(**tensors)
    html = tviewer.vis_3dgs(splats, tmp_path / "sub" / "s.html").read_text()
    assert html.encode() == want
    for ch, closing in (("{", "}"), ("(", ")"), ("[", "]")):
        assert html.count(ch) == html.count(closing), ch
    data = re.search(r'const B64 = "([^"]*)"', html).group(1)
    assert len(base64.b64decode(data)) == 64 * 32


def test_vis_colmap_matches_jax(tmp_path):
    from tests.test_points_colmap import write_colmap_fixture

    write_colmap_fixture(tmp_path)
    for kw in (dict(), dict(auto_orient=False, max_num_points=1, frustum_scale=0.1, seed=3)):
        out = tviewer.vis_colmap(tmp_path, tmp_path / "t" / "colmap.html", **kw)
        want = jviewer.vis_colmap(tmp_path, tmp_path / "j" / "colmap.html", **kw)
        html = out.read_text()
        assert html == want.read_text()
        assert "<html" in html.lower() and "__DATA__" not in html and len(html) > 10_000
    with pytest.raises(FileNotFoundError, match="no COLMAP sparse model"):
        tviewer.vis_colmap(tmp_path / "images", tmp_path / "x.html")


def test_video_renderer_gif_and_png_fallback(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    frames = [rng.uniform(size=(8, 10, 3)).astype(np.float32) for _ in range(3)]
    with open_video_renderer(tmp_path / "clip.gif", fps=5) as put:
        for f in frames:
            put(torch.from_numpy(f))
    with j_open_video_renderer(tmp_path / "j" / "clip.gif", fps=5) as put:
        for f in frames:
            put(f)
    assert (tmp_path / "clip.gif").read_bytes() == (tmp_path / "j" / "clip.gif").read_bytes()

    # whatever this machine's encoders: a video, or the PNG sequence
    with open_video_renderer(tmp_path / "any.mp4", fps=8) as put:
        put(frames[0])
    assert (tmp_path / "any.mp4").exists() or (tmp_path / "any" / "frame_00000.png").exists()
    # without imageio (as on the card): the warning and the PNG sequence
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.warns(UserWarning, match="no video encoder"):
        with open_video_renderer(tmp_path / "clip.mp4", fps=8) as put:
            for f in frames:
                put(f)
    pngs = sorted(p.name for p in (tmp_path / "clip").iterdir())
    assert pngs == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "clip" / pngs[1])),
                                  (frames[1] * 255).astype(np.uint8))
    with open_video_renderer(tmp_path / "seq", fps=8) as put:
        put(frames[0])
    assert (tmp_path / "seq" / "frame_00000.png").exists()
    with open_video_renderer(tmp_path / "empty.gif") as put:
        pass
    assert not (tmp_path / "empty.gif").exists()


def test_console_charts_and_screen(monkeypatch):
    vals = [3.0, 2.0, 1.0, 2.0, 0.5, 4.25]
    assert tconsole.sparkline(vals) == jconsole.sparkline(vals)
    assert tconsole.sparkline(vals, width=3) == jconsole.sparkline(vals, width=3)
    assert tconsole.sparkline([]) == ""
    for kw in (dict(width=10, height=4, label="loss"), dict(width=4, height=6), dict()):
        assert tconsole.line_plot(vals, **kw) == jconsole.line_plot(vals, **kw)
    assert tconsole.line_plot(vals, width=10, height=4, label="loss").count("\n") == 4
    c = tconsole.ConsoleProxy()
    with c.screen("t", num_steps=3) as upd:
        for s in range(1, 4):
            upd(s, {"loss": torch.tensor(1.0 / s), "psnr": float(s)})
    with c.screen("t2", compact=True) as upd:
        upd(1, {"loss": 0.5})
        upd(2, {"loss": 0.25, "note": "x"})
    with c.progress("p") as track:
        assert list(track(range(3))) == [0, 1, 2]
    with c.status("working"):
        c.print("done")
    # without rich the dashboard says what is missing
    monkeypatch.setitem(sys.modules, "rich", None)
    with pytest.raises(ImportError, match="`rich`"):
        with tconsole.ConsoleProxy().screen("t"):
            pass


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from chip_smoke import write_sphere_scene

    root = tmp_path_factory.mktemp("scene")
    write_sphere_scene(root, {"train": 4, "val": 1, "test": 1}, 32, "cpu")
    return root


def test_gsplat_task_writes_turntable_frames_and_html(scene, tmp_path, monkeypatch):
    from geosplatting_tpu_torch.engine.train_task import GSplatTrainTask

    monkeypatch.chdir(tmp_path)
    task = GSplatTrainTask(
        dataset_path=scene, experiment_name="vis", seed=0, num_steps=6, batch_size=1,
        num_steps_per_save=6, num_steps_per_val=6, num_val_images=1, scale_factor=16 / 800,
        num_init_gaussians=300, sh_degree=0, device="cpu", turntable="+z",
        vis_export_every=3, dashboard=True)
    run_dir = Path(task.run()["output_dir"])
    frames = sorted((run_dir / "dump" / "vis").glob("*.png"))
    viz = OptimizationVisualizer(up="+z", resolution=(16, 16), device="cpu")
    viz.setup(6)
    assert [int(p.stem) for p in frames] == sorted(viz._sequence)
    from PIL import Image

    for p in frames:
        img = np.asarray(Image.open(p))
        assert img.shape == (16, 16, 4) and p.stat().st_size > 0
    htmls = sorted((run_dir / "vis_html").glob("*.html"))
    assert [p.name for p in htmls] == ["000003.html", "000006.html"]
    data = re.search(r'const B64 = "([^"]*)"', htmls[-1].read_text()).group(1)
    assert len(base64.b64decode(data)) == 300 * 32
    assert "vis_html snapshot" in (run_dir / "log.txt").read_text()
    # the options reach the dumped config, as the CLIs' --flags do
    assert "turntable='+z'" in (run_dir / "task.py").read_text()


def test_stage1_and_stage3_vis_splats(tmp_path):
    from geosplatting_tpu_torch.engine.train_task import (
        GeoSplatDeferTrainTask, GeoSplatTrainTask,
    )
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer

    model = GeoSplatter(resolution=8, light_resolution=16, scale=1.0, triplane_resolution=16,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.sdf.copy_(torch.linalg.norm(model.grid.base_vertices("cpu"), dim=-1) - 0.5)
    sp = GeoSplatTrainTask().vis_splats(model)
    num = len(sp["means"])
    assert num > 0 and num % 6 == 0
    assert all(v.shape[0] == num and torch.isfinite(v).all() for v in sp.values())
    assert float(sp["colors"].min()) >= 0 and float(sp["colors"].max()) <= 1
    page = tviewer.vis_3dgs(sp, tmp_path / "s1.html").read_text()
    assert len(base64.b64decode(re.search(r'const B64 = "([^"]*)"', page).group(1))) == num * 32

    defer = GeoSplatterDefer(num_gaussians=10, ks_resolution=8, ks_components=4, device="cpu")
    with torch.no_grad():
        defer.kd.uniform_(-0.5, 1.5)
    sp3 = GeoSplatDeferTrainTask().vis_splats(defer)
    assert sp3["means"] is defer.means and float(sp3["colors"].detach().max()) <= 1
    tviewer.vis_3dgs(sp3, tmp_path / "s3.html")


def test_visualization_exports_the_jax_names():
    import geosplatting_tpu.visualization as jvis
    import geosplatting_tpu_torch.visualization as tvis

    def public(mod):
        return {k for k, v in vars(mod).items()
                if not k.startswith("_") and not isinstance(v, type(mod))}

    assert public(tvis) == public(jvis)


@pytest.mark.parametrize("cli", ["train_geosplat", "train_geosplat_mc", "train_geosplat_defer",
                                 "train_geosplat_prior", "train_gsplat"])
def test_cli_flags_reach_the_task(cli, monkeypatch):
    """Each CLI takes --dashboard, --turntable and --vis_export_every, as the
    JAX CLI of the same name does, with the JAX task's defaults."""
    import dataclasses
    import importlib.util

    from geosplatting_tpu_torch.engine.train_task import _TrainTaskBase
    from geosplatting_tpu_torch.utils.config import run_task_group

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(f"_jax_{cli}", root / "scripts" / f"{cli}.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    tcli = importlib.import_module(f"geosplatting_tpu_torch.scripts.{cli}")
    names = ("dashboard", "turntable", "vis_export_every")
    jfields = {f.name: f.default for f in dataclasses.fields(jcli.TASKS["custom"])}
    tfields = {f.name: f.default for f in dataclasses.fields(tcli.TASKS["custom"])}
    assert {k: tfields[k] for k in names} == {k: jfields[k] for k in names}
    seen = {}
    monkeypatch.setattr(_TrainTaskBase, "run", lambda self, *a, **k: seen.update(task=self))
    run_task_group(tcli.TASKS, ["custom", "--dashboard", "true", "--turntable", "+y",
                                "--vis_export_every", "25"])
    task = seen["task"]
    assert (task.dashboard, task.turntable, task.vis_export_every) == (True, "+y", 25)
