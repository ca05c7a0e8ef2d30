"""The share of the SDF sphere trace's ray-steps taken by a ray not yet
settled, %: the port's counters ``sdf_trace.live_ray_steps`` over
``sdf_trace.ray_steps`` for the traced window. None where the program has
no such counters or the device ran nothing."""
import importlib

from benchmark.systems.common import PROGRAM


def read(ctx: dict) -> float | None:
    if ctx["trace"].busy_s <= 0:
        return None
    try:
        totals = importlib.import_module(f"{PROGRAM}.counters").totals()
    except ModuleNotFoundError:
        return None
    if not totals.get("sdf_trace.ray_steps") or "sdf_trace.live_ray_steps" not in totals:
        return None
    return 100.0 * totals["sdf_trace.live_ray_steps"] / totals["sdf_trace.ray_steps"]
