"""The device's idle share of the traced window, %: 1 - busy / window, busy
being the union of the device's kernels, copies and fills."""


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
