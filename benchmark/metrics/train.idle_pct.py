"""Share of the traced training window in which the card ran no kernel, copy
or memset: 100 × (1 − busy / window), busy the union of device intervals."""


def read(view):
    if not view.events or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
