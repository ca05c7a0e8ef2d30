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

- ``shade.points``: the rows ``ops.envshade.env_shade`` shades, and the rows
  of stage 1's split-sum shading (``models.geosplat.shade_colors_splitsum``),
  once a camera (shapes).
- ``shade.covered_points``: those of the rows that can reach the image, as
  each caller knows them: stage 1 (``models.geosplat``) its Gaussians at or
  over the compositing's alpha cutoff, and stage 2 (``models.geosplat_mc``)
  its valid ones, both the Gaussians that are not padding; stage 3
  (``models.geosplat_defer``) its pixels with alpha > 0.
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

``BackwardSpan`` marks a region's backward on autograd's thread as a span
(``envshade.loop_backward``, ``geosplat.light_backward``); its callers make
one only while ``recording()``.
"""
from __future__ import annotations

import collections

import torch
from torch.profiler import record_function

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


class BackwardSpan:
    """The range ``name`` on autograd's thread around the backward of a
    region of the graph: it opens when the first gradient reaches the
    region's output (``open_at``) and closes once the nodes of
    ``first_out``'s part of the region with an edge out of it, the last to
    run, have handed on every gradient they make for the region's
    ``inputs`` (for a loop, ``first_out`` is its first step's output).
    Hooks on the graph's nodes mark both ends; they read no gradient and
    change none, so the gradients are an untraced run's bit for bit (an
    identity ``autograd.Function`` on the inputs would sum an input's
    gradients from inside and outside the region in another order). Every
    differentiable tensor entering the region has to be among ``inputs``."""

    def __init__(self, name: str, first_out: tuple, inputs: tuple):
        # the nodes with an edge out of the region: to an input's node, or
        # to a leaf input's gradient accumulator
        stop = {x.grad_fn for x in inputs if x.grad_fn is not None}
        todo = [x.grad_fn for x in first_out if x.grad_fn is not None]
        seen, last = set(), []
        while todo:
            node = todo.pop()
            if node in seen:
                continue
            seen.add(node)
            leaves = False
            for nxt, _ in node.next_functions:
                if nxt is None:
                    continue
                if nxt in stop or type(nxt).__name__ == "AccumulateGrad":
                    leaves = True
                else:
                    todo.append(nxt)
            if leaves:
                last.append(node)
        self.name = name
        self.pending = len(last)
        self.range = None
        for node in last:
            node.register_hook(self._close)

    def open_at(self, out: tuple) -> None:
        for x in out:
            if x.grad_fn is not None:
                x.grad_fn.register_prehook(self._open)

    def _open(self, grad_outputs):
        if self.range is None:
            self.range = record_function(self.name)
            self.range.__enter__()

    def _close(self, grad_inputs, grad_outputs):
        self.pending -= 1
        if self.pending == 0 and self.range is not None:
            self.range.__exit__(None, None, None)
