"""The share of the shaded rows that can reach the image, %: the port's
counters ``shade.covered_points`` over ``shade.points`` for the traced
window (stage 2: valid Gaussians, not padding; stage 3: pixels with alpha
> 0). None where the program has no such counters or the device ran
nothing."""
import importlib

from benchmark.systems.common import PROGRAM


def read(ctx: dict) -> float | None:
    if ctx["trace"].busy_s <= 0:
        return None
    try:
        totals = importlib.import_module(f"{PROGRAM}.counters").totals()
    except ModuleNotFoundError:
        return None
    if not totals.get("shade.points") or "shade.covered_points" not in totals:
        return None
    return 100.0 * totals["shade.covered_points"] / totals["shade.points"]
