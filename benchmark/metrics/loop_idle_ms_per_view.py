"""Idle device ms a view while the Monte-Carlo loop runs: the union of the
host intervals of ``envshade.loop`` and ``envshade.loop_backward`` (on
autograd's thread), less its overlap with the device's busy time. What the
host's pace costs inside the loop's forward and backward."""
import numpy as np

from benchmark.trace import _merge


def _busy_before(busy: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Busy ns before each time in ``x``; ``busy`` sorted, disjoint."""
    done = np.concatenate(([0], np.cumsum(busy[:, 1] - busy[:, 0])))
    i = np.searchsorted(busy[:, 1], x, side="right")   # intervals ended by x
    start = busy[np.minimum(i, len(busy) - 1), 0]
    return done[i] + np.where(i < len(busy), np.clip(x - start, 0, None), 0)


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    parts = [t.spans[n] for n in ("envshade.loop", "envshade.loop_backward") if n in t.spans]
    if not parts or t.busy_s <= 0:
        return None
    union = _merge([tuple(x) for p in parts for x in p.tolist()])
    overlap = _busy_before(t.busy, union[:, 1]) - _busy_before(t.busy, union[:, 0])
    idle_ns = float((union[:, 1] - union[:, 0]).sum() - overlap.sum())
    return idle_ns / 1e6 / ctx["views"]
