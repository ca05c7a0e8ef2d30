"""K1's share of its roofline, %: the least time the chip could take for the
work of the window's last call of K1 (``roofline.pass_work`` on its captured
inputs, each pass's bytes or operations at the peak) over the device time
of that call's kernels in the trace."""
from benchmark import roofline


def read(ctx: dict) -> float | None:
    passes = ctx["passes"]
    bound, device_s = 0.0, 0.0
    for name in roofline.K1:
        if name not in passes:
            return None
        bound += passes[name]["bound_ms"] / 1e3
        for kernel in roofline.PASS_KERNELS[name]:
            last = ctx["trace"].last_launches(kernel)
            if not last:
                return None
            device_s += last[-1]
    return 100.0 * bound / device_s
