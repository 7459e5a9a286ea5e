"""The device's idle share of the traced window, %: 1 - the union of the
intervals in which a kernel, copy or memset ran, over the window's wall,
across whole steps or requests."""


def read(w):
    if w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
