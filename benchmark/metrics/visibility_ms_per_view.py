"""Device ms a view of the SDF sphere trace of the shading's samples
(``envshade.visibility``)."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("envshade.visibility")
    return None if s is None else s * 1e3 / ctx["views"]
