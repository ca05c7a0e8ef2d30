"""The SDF sphere trace's exit rule, on the plain path, on the CPU.

K4 (``csrc/sdf_trace.cu``) stops a ray after the step in which v reached 0
or t did not change (t = t_max, the point there sampled once). Here the
plain march is run step by step: the v at that step must equal the v after
all the steps, bit for bit, for every ray. The noisy SDF is negative on
parts of the grid's box, so the sample at t_max changes some rays' v: a rule
that stopped a ray on reaching t_max, before sampling there, would be wrong.
No JAX; the helpers also build the card's tests (``test_torch_kernels_gpu``).

Run it alone: ``python -m pytest tests/test_torch_sdf_trace.py -q``.
"""
import pytest
import torch

from benchmark import harness
from geosplatting_tpu_torch import counters
from geosplatting_tpu_torch.ops.sdf_visibility import (
    _box_distance, _pack_cells, _trilerp_w8, make_sdf_visibility, make_sdf_visibility_plain,
)

SCALE = 0.8
STEPS = 24


def lattice(r: int, scale: float = SCALE, device="cpu") -> torch.Tensor:
    """The grid's vertices [r+1, r+1, r+1, 3] ([z, y, x]) in [-scale, scale]^3."""
    a = (torch.arange(r + 1.0, device=device) / r * 2 - 1) * scale
    z, y, x = torch.meshgrid(a, a, a, indexing="ij")
    return torch.stack((x, y, z), -1)


def sphere_sdf(r: int, scale: float = SCALE, device="cpu") -> torch.Tensor:
    """The benchmark cells' stage-1 state: a sphere of radius 0.45."""
    return (torch.linalg.norm(lattice(r, scale, device), dim=-1) - 0.45).reshape(-1)


def noisy_sdf(r: int, scale: float = SCALE, device="cpu", seed: int = 3) -> torch.Tensor:
    """The sphere with N(-1, 2) noise on the box's faces: negative there in
    places, as a learnt SDF may be."""
    v = lattice(r, scale, device)
    g = torch.Generator(device=device).manual_seed(seed)
    face = v.abs().amax(-1) >= scale * (1 - 1e-6)
    noise = 2.0 * torch.randn(v.shape[:-1], generator=g, device=device) - 1.0
    return (torch.linalg.norm(v, dim=-1) - 0.45 + torch.where(face, noise, 0.0)).reshape(-1)


SDFS = {"sphere": sphere_sdf, "noisy": noisy_sdf}


def rays(n: int, device="cpu", seed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Origins in a shell about the sphere (radius 0.44-0.54), unit
    directions in every direction."""
    g = torch.Generator(device=device).manual_seed(seed)
    unit = lambda: torch.nn.functional.normalize(  # noqa: E731
        torch.randn(n, 3, generator=g, device=device), dim=-1)
    dirs = unit()
    origins = unit() * (0.44 + 0.1 * torch.rand(n, 1, generator=g, device=device))
    return origins.contiguous(), dirs.contiguous()


def march_steps(sdf, r, origins, dirs, num_steps=STEPS, scale=SCALE, softness=8.0,
                t_start=0.02):
    """The plain march, step by step: t and v before the first step and
    after each, [num_steps + 1, M] each (``make_sdf_visibility_plain``'s
    arithmetic)."""
    t_max, min_step = 4.0 * scale, scale / num_steps * 0.5
    corners = _pack_cells(sdf.reshape(r + 1, r + 1, r + 1))
    res, hi = sdf.new_tensor([r, r, r]), torch.tensor([r - 1] * 3)

    def sample(p):
        g = (p / scale * 0.5 + 0.5) * res
        g0 = torch.floor(g).long()
        g0c = torch.minimum(g0.clamp(min=0), hi)
        cell = (g0c[..., 2] * r + g0c[..., 1]) * r + g0c[..., 0]
        vals = (corners[cell] * _trilerp_w8(g - g0)).sum(-1)
        d_box = _box_distance(p, scale)
        return torch.where(d_box > 0, vals + d_box, vals)

    t = torch.full(origins.shape[:-1], t_start)
    v = torch.ones(origins.shape[:-1])
    ts, vs = [t], [v]
    for _ in range(num_steps):
        d = sample(origins + dirs * t[..., None])
        v = torch.minimum(v, torch.clamp(softness * d / torch.clamp(t, min=1e-4), 0.0, 1.0))
        t = torch.clamp(t + torch.clamp(d, min=min_step), max=t_max)
        ts.append(t)
        vs.append(v)
    return torch.stack(ts), torch.stack(vs)


@pytest.mark.parametrize("kind", ["sphere", "noisy"])
def test_the_exit_step_holds_the_final_v(kind):
    r, n = 16, 20_000
    sdf = SDFS[kind](r)
    origins, dirs = rays(n)
    ts, vs = march_steps(sdf, r, origins, dirs)
    assert torch.equal(vs[-1], make_sdf_visibility_plain(sdf, (r,) * 3, SCALE)(origins, dirs))

    # the kernel's exit: after the first step whose v is 0 or whose t is
    # the t of the step before; the last step where neither happens
    settled = (vs[1:] == 0) | (ts[1:] == ts[:-1])
    exit_step = torch.where(settled.any(0), settled.float().argmax(0) + 1, STEPS)
    rows = torch.arange(n)
    assert torch.equal(vs[exit_step, rows], vs[-1])
    assert 0 < int((exit_step < STEPS).sum()) < n

    # the step that samples t_max first changes v only where the SDF is
    # negative on the box's faces
    at_max = ts[:-1] == torch.tensor(4.0 * SCALE)
    first = at_max.float().argmax(0)
    changed = at_max.any(0) & (vs[first + 1, rows] != vs[first, rows])
    assert bool(at_max.any(0).sum() > n // 4)
    assert bool(changed.any()) == (kind == "noisy")
    assert bool((sdf < 0).any()) and bool((vs[-1] > 0).any())


def test_an_sdf_on_the_cpu_takes_the_plain_path():
    r = 8
    sdf = sphere_sdf(r)
    origins, dirs = rays(500)
    got = make_sdf_visibility(sdf, (r,) * 3, SCALE, num_steps=12)(origins, dirs)
    want = make_sdf_visibility_plain(sdf, (r,) * 3, SCALE, num_steps=12)(origins, dirs)
    assert torch.equal(got, want)


def test_trace_issued_share_reads_the_kernels_counter(monkeypatch):
    from benchmark.trace import Trace

    ctx = {"trace": Trace([("k", 0, 10, 1)], [], window_s=1e-6), "views": 1, "steps": 1}
    monkeypatch.setattr(counters, "totals", lambda: {
        "sdf_trace.ray_steps": 1000, "sdf_trace.live_ray_steps": 200,
        "sdf_trace.issued_ray_steps": 310})
    assert harness.read_metric("trace_issued_share", ctx) == pytest.approx(31.0)
    # the plain path counts no issued steps; a program without the counter
    monkeypatch.setattr(counters, "totals", lambda: {
        "sdf_trace.ray_steps": 1000, "sdf_trace.live_ray_steps": 200})
    assert harness.read_metric("trace_issued_share", ctx) is None
    empty = {"trace": Trace([], [], window_s=1e-6), "views": 1, "steps": 1}
    assert harness.read_metric("trace_issued_share", empty) is None
