"""The benchmark's stage-1 cell (``s1_s4r.train800x8``) on the CPU at a tiny
size, and the spans and counters of stage 1's split-sum lighting.

The program and the frozen reference (``benchmark/reference/plain``) run the
same plain path here, so the cell is ``correct``; with the optimizer's
update taken out it is not. While a profiler records, ``GeoSplatter`` opens
``geosplat.envmap`` (the prefilter), ``geosplat.splitsum`` (each camera's
colours) and, on autograd's thread, ``geosplat.light_backward`` (each
camera's lookups and the prefilter, backward), and counts the split-sum
rows as ``shade.points`` / ``shade.covered_points``; the gradients stay an
unrecorded step's bit for bit. Tiny shapes, no JAX.

Run it alone: ``python -m pytest tests/test_bench_stage1.py -q``.
"""
import functools

import pytest
import torch
from torch.profiler import profile

from benchmark import faults, harness, traffic as tr
from benchmark.systems.common import PROGRAM, REFERENCE, package
from benchmark.trace import Trace
from geosplatting_tpu_torch import counters

from .torch_parity import one_torch_thread  # noqa: F401

CELL = "s1_s4r.train800x8"
TINY_CONFIG = dict(grid=8, light_resolution=16, triplane_resolution=16, triplane_components=8,
                   pairs_budget=20000, max_render_faces=1024)
TINY_TRAFFIC = dict(resolution=32, views=4, batch=2)
SEED = 2**31 + 1234


@pytest.fixture(autouse=True)
def fresh_counters():
    counters.reset()
    yield
    counters.reset()


def tiny_run() -> dict:
    return harness.run_cell(CELL, SEED, 0.3, False, torch.device("cpu"), 0.0,
                            config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC)


def tiny_step(batched: bool, record: bool):
    """One step of the cell's program at the tiny size, from fresh counters:
    (the run, its metrics, the profiler or None, the counters' totals right
    after the step)."""
    c = harness.cell(CELL, dict(TINY_CONFIG, batched_binning=batched), TINY_TRAFFIC)
    device = torch.device("cpu")
    run = harness.TrainRun(c, package(PROGRAM), SEED, device)
    gt = tr.ground_truth(tr.orbit(package(REFERENCE), c["traffic"], device),
                         list(range(c["traffic"]["views"])))
    counters.reset()
    if not record:
        m = run.step(0, gt)
        return run, m, None, counters.totals()
    with profile() as prof:
        m = run.step(0, gt)
    return run, m, prof, counters.totals()


@pytest.fixture(scope="module")
def tiny_steps():
    """``tiny_step``, each (batched, record) stepped once for the module."""
    return functools.cache(tiny_step)


def test_cell_agrees_with_the_reference_at_a_tiny_size():
    out = tiny_run()
    assert out["correct"] is True, out["checks"]
    assert all(v["value"] == 0 for v in out["checks"].values()), out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out["metrics"]) == ["views_per_s", "peak_mem_gib", "setup_s"]


def test_state_left_unchanged_is_not_correct():
    with faults.state_unchanged():
        out = tiny_run()
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("batched", [False, True], ids=["per_camera", "batched"])
def test_lighting_spans_and_split_sum_counters(tiny_steps, batched):
    run, m, prof, tot = tiny_steps(batched, record=True)
    batch = TINY_TRAFFIC["batch"]
    events = prof.events()

    def ranges(name):
        return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]

    assert len(ranges("geosplat.envmap")) == 1
    assert len(ranges("geosplat.splitsum")) == batch
    # each camera's lookups, then the prefilter once, inside the backward
    light = ranges("geosplat.light_backward")
    (bs, be), = ranges("trainer.backward")
    assert len(light) == batch + 1
    assert all(bs <= s and e <= be for s, e in light)
    # the rasterizer's backward (camera by camera) runs between them, never inside one
    raster = ranges("rasterize.backward")
    assert len(raster) == batch
    assert not any(ls <= rs < le for ls, le in light for rs, _ in raster)
    rows = 6 * run.shapes["jitter"][0]   # 6 Gaussians a face of the static budget
    assert tot["shade.points"] == batch * rows
    assert tot["shade.covered_points"] == batch * int(m["num_gaussians"])
    assert 0 < tot["shade.covered_points"] < tot["shade.points"]


@pytest.mark.parametrize("batched", [False, True], ids=["per_camera", "batched"])
def test_gradients_bit_equal_with_the_profiler_recording(tiny_steps, batched):
    plain, m_plain, _, _ = tiny_steps(batched, record=False)
    traced, m_traced, _, _ = tiny_steps(batched, record=True)
    assert float(m_plain["loss"]) == float(m_traced["loss"])
    for (name, a), b in zip(plain.trainer.model.named_parameters(),
                            traced.trainer.model.parameters()):
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(a, b), name
    assert plain.trainer.model.cubemap.grad.abs().sum() > 0


def test_no_profiler_no_lighting_counts(tiny_steps):
    _, _, _, tot = tiny_steps(False, record=False)
    assert not any(k.startswith("shade.") for k in tot)


def test_lighting_metrics_on_a_hand_built_trace():
    device = [("k_prefilter", 100, 40, 95), ("k_lookup", 200, 10, 190),
              ("k_scatter", 300, 30, 260), ("k_blur_bwd", 400, 20, 350)]
    host = [("geosplat.envmap", 90, 60, True), ("geosplat.splitsum", 180, 20, True),
            ("geosplat.light_backward", 250, 20, True),
            ("geosplat.light_backward", 340, 80, True)]
    ctx = {"trace": Trace(device, host, window_s=1e-6), "views": 2, "steps": 1}
    assert harness.read_metric("envmap_ms_per_step", ctx) == pytest.approx(40e-6)
    assert harness.read_metric("splitsum_ms_per_view", ctx) == pytest.approx(5e-6)
    assert harness.read_metric("light_backward_ms_per_view", ctx) == pytest.approx(25e-6)
    # a program without the spans: no reading
    bare = {"trace": Trace(device, [("trainer.backward", 0, 500, True)], window_s=1e-6),
            "views": 2, "steps": 1}
    for name in ("envmap_ms_per_step", "splitsum_ms_per_view", "light_backward_ms_per_view"):
        assert harness.read_metric(name, bare) is None, name
