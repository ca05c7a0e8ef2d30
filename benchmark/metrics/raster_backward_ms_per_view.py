"""Device ms a view launched under the Gaussian rasterizer's compositing
backward (``rasterize.backward``): K2 and the gradients' assembly."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("rasterize.backward")
    return None if s is None else s * 1e3 / ctx["views"]
