"""The whole step's share of the card's peak, %: the model's FLOPs in
the traced units (`yardstick.unit_work`: dense products from the shapes,
attention over the pairs its mask keeps, three times the forward for
training) over the window's seconds at 165 TFLOP/s."""
from portbench import yardstick


def read(w):
    if w.window_s <= 0:
        return None
    return 100.0 * w.units * w.work.flops / (w.window_s * yardstick.PEAK_FLOPS)
