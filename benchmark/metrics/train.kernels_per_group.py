"""Device kernels launched a group step in the traced window (a count: fused
Adam, CUDA graphs or fewer small kernels lower it)."""


def read(view):
    kernels = view.select(("kernel",))
    if not kernels or view.units == 0:
        return None
    return len(kernels) / view.units
