"""The decoder's three transposed convs with their BatchNorms as one unit of
work: its least time (``yardstick.decoder_tail_work``: operations over the
operand type's peak or bytes over the memory rate, the larger) over the
device time of every kernel launched inside the benchmark's span around the
decoder after the pre-net (``GeneratorDecoder.tail``). It reads the same work
whether the fused f32 tail or the layered bf16 launches run it."""
from benchmark import yardstick

SPAN = "decoder_tail"


def read(view):
    if view.peaks is None:
        return None
    device_s = view.seconds(view.select(("kernel", "gpu_memcpy", "gpu_memset"), in_spans=(SPAN,)))
    if device_s <= 0:
        return None
    flops, nbytes = yardstick.decoder_tail_work(view.gan, int(view.traffic["rows_per_call"]))
    return 100.0 * view.units * yardstick.least_seconds(flops, nbytes, view.peaks, view.precision) / device_s
