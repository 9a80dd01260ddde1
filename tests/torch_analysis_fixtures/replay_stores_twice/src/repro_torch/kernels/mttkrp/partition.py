"""Violating fixture for kernel-contract: the replay's slices overlap.

Slice bounds 1 and 2 trade places, so that slice 0 runs to bound 2, slice 1
is empty and slice 2 starts back at bound 1: the runs between the two are
summed and stored by both slices.
"""

import contextlib

from repro_torch.kernels.mttkrp import partition as _real
from repro_torch.kernels.mttkrp.partition import stream_entries_read  # noqa: F401

_bounds = _real.slice_bounds


def _overlapping(nnz_pad, slices):
    b = _bounds(nnz_pad, slices).copy()
    if slices >= 3:
        b[1], b[2] = b[2], b[1]
    return b


@contextlib.contextmanager
def _faulty():
    _real.slice_bounds = _overlapping
    try:
        yield
    finally:
        _real.slice_bounds = _bounds


def emulate_split(*args, **kwargs):
    with _faulty():
        return _real.emulate_split(*args, **kwargs)


def emulate_tiles(*args, **kwargs):
    with _faulty():
        return _real.emulate_tiles(*args, **kwargs)
