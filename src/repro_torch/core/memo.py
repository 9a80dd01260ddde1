"""Identity-anchored memoization helper (copy of ``repro.core.memo``).

Host-side preprocessing (MTTKRP plans) and device uploads are memoized
per source object, but the sources are unhashable numpy containers, so
caches key on ``id()``.  A bare ``id()`` key is unsound because CPython
recycles ids after garbage collection; every entry therefore pins a
strong reference to its anchor and lookups verify identity.
"""

from __future__ import annotations

from typing import Any

__all__ = ["IdentityKeyedCache"]


class IdentityKeyedCache:
    """Memo keyed by ``(id(anchor), *key)`` with identity verification.

    Eviction is wholesale (clear at ``max_entries``): entries are cheap
    to rebuild and the cap only bounds memory of long-lived sessions.
    """

    def __init__(self, max_entries: int = 64) -> None:
        self.max_entries = max_entries
        self._store: dict[tuple, tuple[Any, Any]] = {}

    def __len__(self) -> int:
        return len(self._store)

    def get(self, anchor: Any, key: tuple) -> Any | None:
        hit = self._store.get((id(anchor),) + key)
        if hit is not None and hit[0] is anchor:
            return hit[1]
        return None

    def clear(self) -> None:
        self._store.clear()

    def put(self, anchor: Any, key: tuple, value: Any) -> Any:
        if len(self._store) >= self.max_entries:
            self._store.clear()
        self._store[(id(anchor),) + key] = (anchor, value)
        return value
