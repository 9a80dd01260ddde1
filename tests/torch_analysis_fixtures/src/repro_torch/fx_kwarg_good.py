"""True-negative fixture for kwarg-threading: forwarded, splatted, resolved."""

import torch


def resolve_device(device):
    return torch.device(device)


def inner(x, *, ordering=None, device="cuda"):
    return (x, ordering, device)


def wrapper(x, *, ordering=None, device="cuda"):
    return inner(x, ordering=ordering, device=device)


def wrapper_splat(x, *, ordering=None, **kwargs):
    return inner(x, ordering=ordering, **kwargs)  # the splat carries device


def wrapper_resolved(x, *, ordering=None, device="cuda"):
    dev = resolve_device(device)
    return inner(x, ordering=ordering, device=dev)


class Holder:
    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self.x = inner(0, device=self.device)
