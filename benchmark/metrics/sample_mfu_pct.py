"""The whole sampling call's share of the card's peak: the copied
``sampling_flops_per_sample`` × rows completed in the traced window, over
the window, over the peak of the configuration's operand type."""
from benchmark import yardstick


def read(view):
    if not view.events or view.peaks is None or view.rows == 0:
        return None
    flops = yardstick.sampling_flops_per_sample(view.gan) * view.rows
    return 100.0 * flops / view.window_s / (view.peaks["tflops"][view.precision] * 1e12)
