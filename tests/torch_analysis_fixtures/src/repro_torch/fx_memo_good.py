"""True-negative fixture for memo-key-completeness."""

from dataclasses import dataclass

from repro_torch.core.memo import IdentityKeyedCache


@dataclass(frozen=True)
class GoodGeometry:
    KEY_FIELDS = ("capacity", "line_bytes")
    capacity: int
    line_bytes: int


def cache_key(signature, mode, reps):
    return (signature, mode, reps)


_CACHE = IdentityKeyedCache()


def lookup(plan, mode, rank):
    hit = _CACHE.get(plan, (mode, rank))
    if hit is None:
        hit = object()
        _CACHE.put(plan, (mode, rank), hit)
    return hit
