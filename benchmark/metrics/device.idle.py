"""The share of the traced window, in %, in which the card runs no kernel,
memcpy or memset: one minus the union of their intervals (not their sum)
over the window's length."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
