"""True-positive fixture for memo-key-completeness: all four rules broken."""

from dataclasses import dataclass, field

from repro_torch.core.memo import IdentityKeyedCache


@dataclass(frozen=True)
class BadGeometry:
    KEY_FIELDS = ("capacity", "stale_field")  # omits line_bytes, names a ghost
    capacity: int
    line_bytes: int


@dataclass(frozen=True)
class BadSignature:
    dims: tuple
    rank: int = field(compare=False, default=0)  # invisible to hash/eq


def bad_key(signature, mode, reps):
    return (signature, mode)  # reps accepted but never hashed


_CACHE = IdentityKeyedCache()


def lookup(plan, mode, rank):
    hit = _CACHE.get(plan, (mode,))
    if hit is None:
        hit = object()
        _CACHE.put(plan, (mode, rank), hit)  # stores under a different key
    return hit
