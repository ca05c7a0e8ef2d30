"""Device ms a view under the trainer's backward (``trainer.backward``): K2, the
Monte-Carlo loop's recomputation and backward, the rest of autograd's work."""


def read(ctx: dict) -> float | None:
    s = ctx["trace"].span_device_s("trainer.backward")
    return None if s is None else s * 1e3 / ctx["views"]
