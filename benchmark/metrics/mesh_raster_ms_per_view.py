"""Device ms a view of stage 3's mesh raster and position interpolation
(``defer.mesh_raster``)."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("defer.mesh_raster")
    return None if s is None else s * 1e3 / ctx["views"]
