"""Device ms a call of the copy of the notes from the card to the host."""

NAME = "DtoH"


def read(view):
    events = view.select(("gpu_memcpy",), name_has=(NAME,))
    if not events or view.units == 0:
        return None
    return 1e3 * view.seconds(events) / view.units
