"""Host ms a call in the program's ``sampler.index`` span: the check of the
emotion names, the list of their indices and its tensor on the card (with
the copy there). Read from ``melogan_torch.utils.profiling.span_table()``,
which holds the program's spans recorded while the traced window's
profiler ran; nothing where the program has no such span."""

SPAN = "sampler.index"


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
