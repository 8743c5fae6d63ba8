"""The conv work the port's own cores run in a group step (the generator's
transposed convs forward and their input gradients, the frozen ED's convs
forward and their input gradients: ``yardstick.train_conv_calls``): the sum
of each call's least time over the device time of the cores' kernels (the
f32 mode's ``prep_w`` prologue and ``igemm_tf32x3_conv``, the bf16 mode's
``igemm_bf16_conv``)."""
from benchmark import yardstick

KERNELS = ("igemm_tf32x3_conv", "prep_w", "igemm_bf16_conv")


def read(view):
    if view.peaks is None or view.units == 0:
        return None
    device_s = view.seconds(view.select(("kernel",), name_has=KERNELS))
    if device_s <= 0:
        return None
    calls = yardstick.train_conv_calls(view.gan, view.ed, int(view.gan["BATCH_SIZE"]))
    least = sum(yardstick.least_seconds(f, b, view.peaks, view.precision) for _, f, b in calls)
    return 100.0 * view.units * least / device_s
