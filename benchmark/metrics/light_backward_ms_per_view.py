"""Device ms a view launched under stage 1's lighting backward
(``geosplat.light_backward``, on autograd's thread): each camera's
split-sum lookups scattered back into the mip atlas, and the prefilter's
backward into the cubemap once a step."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("geosplat.light_backward")
    return None if s is None else s * 1e3 / ctx["views"]
