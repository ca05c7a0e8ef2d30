"""The port's counters: one registry for what a run counts.

``launches[<kernel>]`` counts the hand-written CUDA kernels' launches
(``_kernels.launch`` adds one after each), always, as Python ints.

``count(name, value)`` counts work where it happens, only while a
``torch.profiler`` records (``torch.autograd._profiler_enabled()``), so a
total covers exactly a profiled window; with no profiler a call costs one
boolean check and launches nothing. A caller that needs device work to make
its value guards it with ``recording()``. A value is a Python int or a 0-dim
tensor; tensors accumulate on their device with no sync, and ``totals()``
reads them all at the end with one.

The counters and what counts them:

- ``shade.points``: the rows ``ops.envshade.env_shade`` shades (a shape).
- ``shade.covered_points``: those of the rows that can reach the image, as
  each caller knows them: stage 2 (``models.geosplat_mc``) its valid, not
  padding, Gaussians; stage 3 (``models.geosplat_defer``) its pixels with
  alpha > 0.
- ``sdf_trace.ray_steps``: the ray-steps the SDF sphere trace
  (``ops.sdf_visibility.make_sdf_visibility``) computes, rays x steps.
- ``sdf_trace.live_ray_steps``: those of them whose ray was unsettled at
  the step's start (t < t_max and v > 0). The card's kernel (K4,
  ``csrc/sdf_trace.cu``) counts them on every ray, exactly; the plain march
  on every 64th ray (``ops.sdf_visibility.LIVE_STRIDE``), scaled to all
  rays. t and v are monotone, so a settled ray stays settled: v = 0 falls
  no further, and once t = t_max every step samples the same point, 2.27
  scale or more from the box's centre for a ray from inside the grid's box.
  That point is sampled once (the step that starts at t_max, not live): an
  SDF positive on the box keeps the term there at 1, but a learnt SDF need
  not be, so K4 stops a ray only after that sample, or after its v reached 0.
- ``sdf_trace.issued_ray_steps``: the lane-steps K4's warps issued: per
  warp, its lanes holding a ray times the steps of its longest ray; at
  least the live steps (plus a ray's sample at t_max), at most the ray-steps.
  The plain march counts none.

Any other implementation of the sphere trace keeps the ``sdf_trace``
counters with these meanings. ``--trace DIR`` (``utils.config``) writes the
totals to ``counters.json``; the benchmark's per-layer metrics read them.
"""
from __future__ import annotations

import collections

import torch

launches: collections.Counter = collections.Counter()
_host: collections.Counter = collections.Counter()
_device: dict[str, torch.Tensor] = {}


def recording() -> bool:
    """Whether ``count`` records now: a profiler is recording."""
    return torch.autograd._profiler_enabled()


def count(name: str, value) -> None:
    """Adds ``value`` (a Python int or a 0-dim tensor) to counter ``name``
    while a profiler records; does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().long()
        prev = _device.get(name)
        _device[name] = value if prev is None else prev + value
    else:
        _host[name] += int(value)


def totals() -> dict[str, int]:
    """Every counter's total: ``launches.<kernel>`` and the counted names.
    Reads the device's accumulators with one sync for each device holding
    some, and keeps their totals on the host from then on."""
    by_device: dict[torch.device, list[str]] = {}
    for name, v in _device.items():
        by_device.setdefault(v.device, []).append(name)
    for names in by_device.values():
        for name, v in zip(names, torch.stack([_device[n] for n in names]).tolist()):
            _host[name] += v
    _device.clear()
    return {**{f"launches.{k}": v for k, v in launches.items()}, **_host}


def reset() -> None:
    """Clears the counted names (``launches`` has ``_kernels.reset_launches``)."""
    _host.clear()
    _device.clear()
