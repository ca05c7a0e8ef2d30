"""Device ms a view launched under the Monte-Carlo loop's backward
(``envshade.loop_backward``, on autograd's thread): the checkpointed steps'
recomputation and gradients."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("envshade.loop_backward")
    return None if s is None else s * 1e3 / ctx["views"]
