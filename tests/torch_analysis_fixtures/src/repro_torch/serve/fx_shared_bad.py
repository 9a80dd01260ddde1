"""True-positive fixture for shared-state-safety: bare dict, request-time writes."""

_RESULTS: dict = {}
_LOG = []


def record(key, value):
    _RESULTS[key] = value  # item assignment on module state


def push(item):
    _LOG.append(item)  # mutating method on module state
