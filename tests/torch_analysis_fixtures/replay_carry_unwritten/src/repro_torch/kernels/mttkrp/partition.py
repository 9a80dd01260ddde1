"""Violating fixture for carry-init: launch 1 marks each slice's last carry
with its row or block but never writes its value, so launch 2 reads a slot
that holds only the replay's initial NaN."""

import contextlib

from repro_torch.kernels.mttkrp import partition as _real
from repro_torch.kernels.mttkrp.partition import stream_entries_read  # noqa: F401

_Carries = _real._Carries


class _Unwritten(_Carries):
    def put(self, w, slot, key, value):
        if slot == 1:
            self.key[w, slot] = key
        else:
            super().put(w, slot, key, value)


@contextlib.contextmanager
def _faulty():
    _real._Carries = _Unwritten
    try:
        yield
    finally:
        _real._Carries = _Carries


def emulate_split(*args, **kwargs):
    with _faulty():
        return _real.emulate_split(*args, **kwargs)


def emulate_tiles(*args, **kwargs):
    with _faulty():
        return _real.emulate_tiles(*args, **kwargs)
