"""The lane-steps the SDF sphere trace's kernel issued, as a share of the
ray-steps of a full march, %: the port's counters
``sdf_trace.issued_ray_steps`` (per warp, its lanes holding a ray times the
steps of its longest ray) over ``sdf_trace.ray_steps`` for the traced
window. Read beside ``trace_live_share``, it shows what warp divergence
adds to the live steps. None where the program has no such counter (the
plain trace counts none) or the device ran nothing."""
import importlib

from benchmark.systems.common import PROGRAM


def read(ctx: dict) -> float | None:
    if ctx["trace"].busy_s <= 0:
        return None
    try:
        totals = importlib.import_module(f"{PROGRAM}.counters").totals()
    except ModuleNotFoundError:
        return None
    if not totals.get("sdf_trace.ray_steps") or "sdf_trace.issued_ray_steps" not in totals:
        return None
    return 100.0 * totals["sdf_trace.issued_ray_steps"] / totals["sdf_trace.ray_steps"]
