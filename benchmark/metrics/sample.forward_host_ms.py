"""Host ms a call in the program's ``sampler.forward`` span: the enqueue of
the feature encoder and the generator (with the rounding Functions under
bf16). Read from ``melogan_torch.utils.profiling.span_table()``; nothing
where the program has no such span."""

SPAN = "sampler.forward"


def read(view):
    if not view.events or view.units == 0:
        return None
    try:
        from melogan_torch.utils.profiling import span_table
    except ImportError:
        return None
    row = span_table().get(SPAN)
    if row is None:
        return None
    return 1e3 * row["host_s"] / view.units
