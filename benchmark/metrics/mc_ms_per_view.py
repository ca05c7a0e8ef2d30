"""Device ms a view of the Monte-Carlo loop's steps (``envshade.mc_step``): the
forward and, in training, the checkpoint's recomputation."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("envshade.mc_step")
    return None if s is None else s * 1e3 / ctx["views"]
