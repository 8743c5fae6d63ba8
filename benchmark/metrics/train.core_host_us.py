"""Host µs a call of the port's CUDA wrappers: the program's ``ops.*`` spans
(``ops.conv1d``, ``ops.convt1d``, ``ops.decoder_tail``: checks, plan,
scratch, launch), summed over every call in the traced window on every
thread (the calling one, and autograd's device thread running the conv
Functions' backwards), over the number of calls. Read from
``melogan_torch.utils.profiling.span_table()``; nothing where the program
has no such span."""

PREFIX = "ops."


def read(view):
    if not view.events or view.units == 0:
        return None
    try:
        from melogan_torch.utils.profiling import span_table
    except ImportError:
        return None
    rows = [row for name, row in span_table().items() if name.startswith(PREFIX)]
    calls = sum(row["count"] for row in rows)
    if calls == 0:
        return None
    return 1e6 * sum(row["host_s"] for row in rows) / calls
