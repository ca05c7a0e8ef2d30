"""Faults planted under the program's timed path, to read what the check
makes of them (``calibrate.py --fault``) and to see ``correct`` fail
(``tests/test_bench_harness.py``). Each is a context manager that patches
the program and restores it.

- ``state_unchanged``: the optimizer's update does nothing, so a training
  step returns its state unchanged;
- ``answer_altered``: the last image of every rendered batch has 0.5 added
  to its colour where it is produced (the model's ``render``).

The cells run one camera a step on one chip, so half of a batch cannot be
left out and there is no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib
import importlib

from .systems.common import PROGRAM


@contextlib.contextmanager
def _patched(module: str, owner: str, name: str, make):
    cls = getattr(importlib.import_module(f"{PROGRAM}.{module}"), owner)
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def state_unchanged():
    return _patched("train.optim", "GroupOptimizers", "step", lambda orig: lambda self: None)


def answer_altered():
    def make(orig):
        def render(self, *args, **kw):
            rgba, reg, aux = orig(self, *args, **kw)
            rgba = rgba.clone()
            rgba[-1, ..., :3] += 0.5
            return rgba, reg, aux
        return render
    return _patched("models.geosplat_defer", "GeoSplatterDefer", "render", make)


FAULTS = {"state_unchanged": state_unchanged, "answer_altered": answer_altered}
