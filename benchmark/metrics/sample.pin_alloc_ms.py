"""Host ms a call in the program's ``sampler.pin_alloc`` span: the
page-locked host buffer the notes are copied into (``cudaHostAlloc`` where
the caching host allocator has no free block). Read from
``melogan_torch.utils.profiling.span_table()``; nothing where the program
has no such span."""

SPAN = "sampler.pin_alloc"


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
