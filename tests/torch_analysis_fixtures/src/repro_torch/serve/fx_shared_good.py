"""True-negative fixture for shared-state-safety: every sanctioned shape."""

from repro_torch.core.memo import IdentityKeyedCache
from repro_torch.dse.autotune import WallTimeMemo

_CACHE = IdentityKeyedCache()  # sanctioned owner
_TIMES = WallTimeMemo()  # sanctioned owner
_AXES: dict = {}
for _name in ("frequency", "wavelengths"):
    _AXES[_name] = ()  # import-time initialization: single-threaded, allowed


def remember(plan, mode, value):
    _CACHE.put(plan, (mode,), value)


def local_scratch():
    buf = []
    buf.append(1)  # function-local, not module state
    return buf


def shadowed(_AXES):
    _AXES["k"] = 1  # parameter shadows the module name
