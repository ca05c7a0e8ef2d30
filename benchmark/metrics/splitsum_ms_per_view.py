"""Device ms a view of stage 1's per-Gaussian split-sum colours
(``geosplat.splitsum``): the analytic FG term and the nearest lookup into
the mip atlas, forward only."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("geosplat.splitsum")
    return None if s is None else s * 1e3 / ctx["views"]
