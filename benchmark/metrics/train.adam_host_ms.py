"""Host ms a group step in the program's ``gan.adam`` spans: the
``CRITIC_ITERS`` critic Adam steps and the generator's. Read from
``melogan_torch.utils.profiling.span_table()``; nothing where the program
has no such span."""

SPAN = "gan.adam"


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
