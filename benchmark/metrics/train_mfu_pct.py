"""The whole group step's share of the card's peak: the copied
``group_step_flops`` at the configuration's batch × group steps in the traced
window, over the window, over the peak of the configuration's operand type."""
from benchmark import yardstick


def read(view):
    if not view.events or view.peaks is None or view.units == 0:
        return None
    flops = yardstick.group_step_flops(view.gan, view.ed, int(view.gan["BATCH_SIZE"])) * view.units
    return 100.0 * flops / view.window_s / (view.peaks["tflops"][view.precision] * 1e12)
