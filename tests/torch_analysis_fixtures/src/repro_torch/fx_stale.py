"""Fixture: a waiver left behind after its finding was fixed."""


def inner(x, *, device="cuda"):
    return (x, device)


def wrapper(x, *, device="cuda"):
    return inner(x, device=device)  # repro_torch: ignore[kwarg-threading] -- stale
