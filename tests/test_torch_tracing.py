"""The port's counters and its spans inside the shading and the rasterizer,
and the benchmark's per-layer metrics that read them, on the CPU.

``geosplatting_tpu_torch.counters`` counts only while a profiler records;
``env_shade`` opens ``envshade.loop`` around its sample loop and
``envshade.loop_backward`` on autograd's thread around the loop's backward;
``rasterize.backward`` covers the compositing backward. Tiny shapes, no JAX.

Run it alone: ``python -m pytest tests/test_torch_tracing.py -q``.
"""
import json
import sys
from dataclasses import dataclass

import pytest
import torch
from torch.profiler import profile
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness
from benchmark.trace import Trace
from geosplatting_tpu_torch import _kernels, counters
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.ops import envshade as es
from geosplatting_tpu_torch.ops import sdf_visibility
from geosplatting_tpu_torch.ops.rasterize import rasterize
from geosplatting_tpu_torch.ops.sdf_visibility import make_sdf_visibility, sample_sdf_grid
from geosplatting_tpu_torch.utils.config import run_task_group

from .torch_parity import one_torch_thread  # noqa: F401

NPTS = 24
SX = 3                      # 9 sample steps
GRID = (8, 8, 8)
SCALE = 1.0
TRACE_STEPS = 6


@pytest.fixture(autouse=True)
def fresh_counters():
    counters.reset()
    yield
    counters.reset()


def sphere_sdf() -> torch.Tensor:
    rx, ry, rz = GRID
    z, y, x = torch.meshgrid(*(torch.arange(r + 1.0) for r in (rz, ry, rx)), indexing="ij")
    v = torch.stack((x / rx, y / ry, z / rz), -1) * 2 - 1
    return (torch.linalg.norm(v - 0.02, dim=-1) - 0.4).reshape(-1)


def inputs(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn(NPTS, 3, generator=g), dim=-1)
    view = torch.tensor([0.3, 0.6, 2.8])
    pos = d * (0.42 + 0.1 * torch.rand(NPTS, 1, generator=g))
    nrm = torch.nn.functional.normalize(0.3 * d + (view - pos), dim=-1)
    h, w = 8, 16
    return {
        "pos": pos, "nrm": nrm, "view": view,
        "kd": 0.2 + 0.6 * torch.rand(NPTS, 3, generator=g),
        "arm": torch.stack((torch.zeros(NPTS), 0.3 + 0.6 * torch.rand(NPTS, generator=g),
                            0.05 + 0.7 * torch.rand(NPTS, generator=g)), -1),
        "light": 0.3 + torch.rand(h, w, 3, generator=g),
        "draws": es.draw_shade(NPTS, num_samples_x=SX, light_bank=64, generator=g),
    }


def shade_and_grads(x: dict) -> list[torch.Tensor]:
    """Forward and backward of a small ``env_shade`` whose kd and normals also
    reach the loss outside it, as in the models; the leaves' gradients."""
    kd, arm, nrm, pos, data = (x[k].clone().requires_grad_()
                               for k in ("kd", "arm", "nrm", "pos", "light"))
    kd2, nrm2 = kd * 1.5, torch.nn.functional.normalize(nrm, dim=-1)
    vis = make_sdf_visibility(sphere_sdf(), GRID, SCALE, num_steps=TRACE_STEPS)
    diff, spec, resi = es.env_shade(pos, nrm2, x["view"], kd2, arm, es.compute_light_pdf(data),
                                    x["draws"], visibility_fn=vis)
    loss = (diff * kd2).sum() + spec.sum() + resi.sum() + (kd2 * kd2).sum() + nrm2.sum()
    loss.backward()
    return [kd.grad, arm.grad, nrm.grad, pos.grad, data.grad]


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def is_subsequence(short: list, long: list) -> bool:
    it = iter(long)
    return all(any(x == y for y in it) for x in short)


# ---- the counters ------------------------------------------------------------------


def test_no_profiler_no_counts_and_no_counting_work():
    x = inputs()
    with OpLog() as off:
        shade_and_grads(x)
    assert not any(k.startswith(("shade.", "sdf_trace.")) for k in counters.totals())
    assert not counters._device
    with profile(), OpLog() as on:
        shade_and_grads(x)
    # the counting adds work only while the profiler records
    assert "aten.count_nonzero" in on.ops and "aten.count_nonzero" not in off.ops
    assert len(on.ops) > len(off.ops) and is_subsequence(off.ops, on.ops)


def test_counts_under_the_profiler_equal_shapes():
    x = inputs()
    with profile():
        shade_and_grads(x)
    tot = counters.totals()
    steps = SX * SX
    assert tot["shade.points"] == NPTS
    # a light and a BSDF shadow ray per point and step, every ray every trace step
    assert tot["sdf_trace.ray_steps"] == 2 * steps * NPTS * TRACE_STEPS
    assert 0 < tot["sdf_trace.live_ray_steps"] <= tot["sdf_trace.ray_steps"]
    assert counters.totals() == tot      # read once: the totals stay on the host


@pytest.mark.parametrize("stride", [1, 7])
def test_live_ray_steps_equal_a_plain_recount(monkeypatch, stride):
    """Every ray (stride 1), and every 7th of 300 scaled by 300 / 43."""
    monkeypatch.setattr(sdf_visibility, "LIVE_STRIDE", stride)
    g = torch.Generator().manual_seed(5)
    rays = 300
    origins = (torch.rand(rays, 3, generator=g) * 2 - 1) * 0.9
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, generator=g), dim=-1)
    sdf = sphere_sdf()
    vis = make_sdf_visibility(sdf, GRID, SCALE, num_steps=TRACE_STEPS)
    with profile():
        vis(origins, dirs)
    tot = counters.totals()
    # the march again, one ray at a time, with the unpacked lookup
    t_max, min_step, live = 4.0 * SCALE, SCALE / TRACE_STEPS * 0.5, 0
    for o, d in zip(origins[::stride], dirs[::stride]):
        t, v = torch.tensor(0.02), 1.0
        for _ in range(TRACE_STEPS):
            live += bool(t < t_max) and v > 0
            dist = sample_sdf_grid(sdf, GRID, SCALE, o + d * t)
            v = min(v, min(max(8.0 * float(dist / t), 0.0), 1.0))
            t = torch.clamp(t + torch.clamp(dist, min=min_step), max=t_max)
    assert tot["sdf_trace.ray_steps"] == rays * TRACE_STEPS
    assert tot["sdf_trace.live_ray_steps"] == live * rays // len(range(0, rays, stride))
    assert 0 < live < len(range(0, rays, stride)) * TRACE_STEPS


def test_count_takes_ints_and_device_values_and_launches_stay():
    assert _kernels.launches is counters.launches
    counters.count("x", 3)          # no profiler: nothing
    with profile():
        counters.count("x", 2)
        counters.count("y", torch.tensor(4))
        counters.count("y", torch.tensor(True))
    _kernels.launches["k_test"] += 1
    try:
        tot = counters.totals()
        assert tot["x"] == 2 and tot["y"] == 5 and tot["launches.k_test"] >= 1
    finally:
        _kernels.launches["k_test"] -= 1
        del _kernels.launches["k_test"]


@dataclass
class _CountingTask:
    n: int = 3

    def run(self):
        counters.count("task.items", self.n)
        return self.n


def test_trace_dir_writes_the_counters(tmp_path):
    out = tmp_path / "trace"
    assert run_task_group({"count": _CountingTask()}, ["--trace", str(out), "count"]) == 3
    assert (out / "trace.json").exists()
    assert json.loads((out / "counters.json").read_text())["task.items"] == 3


# ---- the spans ---------------------------------------------------------------------


def test_loop_backward_encloses_the_recomputation_and_grads_are_bit_equal():
    x = inputs(1)
    plain = shade_and_grads(x)
    with profile() as prof:
        traced = shade_and_grads(x)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    ev = [e for e in prof.events() if e.name.startswith("envshade.")]
    loop = [e.time_range for e in ev if e.name == "envshade.loop"]
    back = [e.time_range for e in ev if e.name == "envshade.loop_backward"]
    steps = [e.time_range for e in ev if e.name == "envshade.mc_step"]
    assert len(loop) == 1 and len(back) == 1
    (ls, le), (bs, be) = (loop[0].start, loop[0].end), (back[0].start, back[0].end)
    forward = [r for r in steps if ls <= r.start and r.end <= le]
    recomputed = [r for r in steps if bs <= r.start and r.end <= be]
    assert len(forward) == SX * SX and len(recomputed) == SX * SX
    assert le <= bs


def test_rasterize_backward_span_on_the_plain_path():
    g = torch.Generator().manual_seed(3)
    n = 200
    means = torch.rand(n, 3, generator=g) * 2 - 1
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    scales = torch.exp(torch.rand(n, 3, generator=g) * 2.5 - 4.5)
    opac = 0.3 + 0.6 * torch.rand(n, generator=g)
    colors = torch.rand(n, 3, generator=g).requires_grad_()
    cam = Cameras.from_lookat(torch.tensor([2.0, 1.0, 1.5]), torch.zeros(3), width=32, height=24)
    with profile() as prof:
        render, alpha, _ = rasterize(means, quats, scales, opac, colors, cam.view_matrix,
                                     cam.intrinsic_matrix, 32, 24)
        render.sum().backward()
    names = [e.name for e in prof.events()]
    assert "rasterize.backward" in names and "rasterize.composite" in names
    assert colors.grad.abs().sum() > 0


# ---- the per-layer metrics that read them ------------------------------------------


def hand_trace() -> Trace:
    """Device busy 100-140 and 300-330 ns; the loop 90-150 ns, its backward
    250-400 ns; a K2 kernel launched under ``rasterize.backward``."""
    device = [("k_loop", 100, 40, 95), ("k2_composite_bwd", 300, 30, 260)]
    host = [("envshade.loop", 90, 60, True), ("envshade.loop_backward", 250, 150, True),
            ("rasterize.backward", 255, 10, True), ("aten::mul", 95, 2, False)]
    return Trace(device, host, window_s=500e-9)


def test_metrics_on_a_hand_built_trace(monkeypatch):
    ctx = {"trace": hand_trace(), "views": 2, "steps": 2}
    # union 90-150, 250-400 = 210 ns, less 40 + 30 busy: 140 ns over 2 views
    assert harness.read_metric("loop_idle_ms_per_view", ctx) == pytest.approx(70e-6)
    assert harness.read_metric("loop_backward_ms_per_view", ctx) == pytest.approx(15e-6)
    assert harness.read_metric("raster_backward_ms_per_view", ctx) == pytest.approx(15e-6)
    monkeypatch.setattr(counters, "totals", lambda: {
        "shade.points": 800, "shade.covered_points": 200,
        "sdf_trace.ray_steps": 1000, "sdf_trace.live_ray_steps": 370})
    assert harness.read_metric("shade_covered_share", ctx) == pytest.approx(25.0)
    assert harness.read_metric("trace_live_share", ctx) == pytest.approx(37.0)
    # overlapping spans count once; busy stretches across a span's edge in part
    t = Trace([("k", 80, 30, 70), ("k", 140, 140, 130)],
              [("envshade.loop", 90, 60, True), ("envshade.loop_backward", 120, 80, True)],
              window_s=500e-9)
    # union 90-200 = 110 ns; busy inside: 90-110 and 140-200 = 80 ns
    assert harness.read_metric("loop_idle_ms_per_view", {"trace": t, "views": 1}) \
        == pytest.approx(30e-6)


def test_metrics_silent_where_nothing_was_recorded(monkeypatch):
    empty = {"trace": Trace([], [("envshade.loop", 0, 10, True)], window_s=1e-6), "views": 1,
             "steps": 1}
    for m in ("loop_idle_ms_per_view", "loop_backward_ms_per_view",
              "raster_backward_ms_per_view", "shade_covered_share", "trace_live_share"):
        assert harness.read_metric(m, empty) is None, m
    # a program without the counters (the module missing) or without these names
    ctx = {"trace": hand_trace(), "views": 1, "steps": 1}
    monkeypatch.setattr(counters, "totals", lambda: {"shade.points": 10})
    assert harness.read_metric("shade_covered_share", ctx) is None
    assert harness.read_metric("trace_live_share", ctx) is None
    monkeypatch.setitem(sys.modules, "geosplatting_tpu_torch.counters", None)
    assert harness.read_metric("shade_covered_share", ctx) is None
