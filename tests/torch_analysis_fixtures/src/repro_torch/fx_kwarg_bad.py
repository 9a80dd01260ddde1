"""True-positive fixture for kwarg-threading: device= accepted, not passed."""


def inner(x, *, ordering=None, device="cuda"):
    return (x, ordering, device)


def wrapper(x, *, ordering=None, device="cuda"):
    return inner(x, ordering=ordering)  # runs inner on its default device
