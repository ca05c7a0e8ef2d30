"""Device ms a view of the Gaussian rasterizer's forward: binning
(``rasterize.bin_pairs``) and compositing with K1 and K3 (``rasterize.composite``)."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("rasterize.bin_pairs", "rasterize.composite")
    return None if s is None else s * 1e3 / ctx["views"]
