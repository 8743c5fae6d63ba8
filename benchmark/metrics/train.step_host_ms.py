"""Host ms a group step in the program's ``gan.group`` span: the critic
updates and the generator update from the first launch's enqueue to the
last's, as the calling thread sees them. Read from
``melogan_torch.utils.profiling.span_table()``; nothing where the program
has no such span."""

SPAN = "gan.group"


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
