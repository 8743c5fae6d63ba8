"""Drivers of the traffic kinds, found by a mix's ``kind``.

Each module holds a ``Cell(config, traffic, seed, device)`` with ``setup()``,
``run_window(seconds)``, ``install_spans(spans)``, ``run_traced()``,
``free_program()`` and ``check()``, and the counts ``attempted`` and
``failed``; ``phases`` lists the set-up's parts with their seconds.
"""
import contextlib
import time


class Phases(list):
    """(name, seconds) of each part of a set-up, in order."""

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.append((name, time.perf_counter() - t0))
