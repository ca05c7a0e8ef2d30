"""Device ms a step of stage 1's environment prefilter, forward only
(``geosplat.envmap``): the mip chain, the per-roughness blur and the diffuse
base of the cubemap, once a step for all of its cameras."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("geosplat.envmap")
    return None if s is None else s * 1e3 / ctx["steps"]
