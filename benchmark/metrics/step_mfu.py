"""The window's share of the chip's FP32 peak, %: the operations its views
need (``opcount.view_ops``, counted from shapes) over the traced window's
time, over 67 TFLOP/s."""
from benchmark import roofline


def read(ctx: dict) -> float | None:
    if ctx["trace"].busy_s <= 0:   # no device trace: nothing ran on a device
        return None
    ops = ctx["view_ops"]["total"] * ctx["views"]
    return 100.0 * ops / ctx["trace"].window_s / roofline.FP32_OPS_PER_S
