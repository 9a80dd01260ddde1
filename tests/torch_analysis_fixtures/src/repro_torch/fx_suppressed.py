"""Fixture: a reviewed kwarg-threading waiver that matches its finding."""


def inner(x, *, device="cuda"):
    return (x, device)


def wrapper(x, *, device="cuda"):
    return inner(x)  # repro_torch: ignore[kwarg-threading] -- x already lies on its device
