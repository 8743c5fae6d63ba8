"""The benchmark's own spans: ``record_function`` annotations around the
calls into the program's layers, put there from outside by forward hooks
(or, for a method that is no module, by wrapping it on the instance). They
are installed for the traced window only."""
from __future__ import annotations

import functools
from typing import List

from torch.autograd.profiler import record_function


class Spans:
    def __init__(self):
        self._undo: List = []

    def around(self, module, name: str) -> None:
        """A span ``name`` around every forward of ``module``."""
        stack: List[record_function] = []

        def enter(_m, _args):
            stack.append(record_function(name).__enter__())

        def leave(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
        self._undo += [h.remove for h in handles]

    def around_method(self, obj, attr: str, name: str) -> None:
        """A span ``name`` around every call of ``obj.attr``."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()
