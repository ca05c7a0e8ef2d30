"""Device ms a step of the stage-2 geometry: FlexiCubes to mesh (``geosplat.geometry``)
and mesh to Gaussians with the field (``geosplat.gaussians``), forward only."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("geosplat.geometry", "geosplat.gaussians")
    return None if s is None else s * 1e3 / ctx["steps"]
