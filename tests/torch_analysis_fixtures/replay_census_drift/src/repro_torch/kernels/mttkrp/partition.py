"""Violating fixture for traffic-model-drift: the replay takes every stream
entry for a nonzero, padding included, so it consumes more values, index
columns and factor rows than the model prices (padding adds nothing to the
output, which stays right)."""

import contextlib

import torch

from repro_torch.kernels.mttkrp import partition as _real
from repro_torch.kernels.mttkrp.partition import stream_entries_read  # noqa: F401

_real_mask = _real.real_mask


def _every_entry(plan_bufs):
    return torch.ones(int(plan_bufs.values.shape[0]), dtype=torch.bool)


@contextlib.contextmanager
def _faulty():
    _real.real_mask = _every_entry
    try:
        yield
    finally:
        _real.real_mask = _real_mask


def emulate_split(*args, **kwargs):
    with _faulty():
        return _real.emulate_split(*args, **kwargs)


def emulate_tiles(*args, **kwargs):
    with _faulty():
        return _real.emulate_tiles(*args, **kwargs)
