"""shared-state-safety: module-level mutable state needs a sanctioned owner.

``repro_torch.serve`` and ``repro_torch.dse`` are the port's layers that
hold state across requests: the service's buckets, the tuner's measured
times.  A bare module-level ``dict``/``list``/``set`` mutated from
request-handling functions is how cross-tenant aliasing starts (a shared
dict fed a partial result poisons every later reader).  The contract: a
module-level mutable container in the watched packages is mutated only
through

  * a ``repro_torch.core.memo.IdentityKeyedCache`` (anchored, verified,
    bounded) or a ``repro_torch.dse.autotune.WallTimeMemo``,
  * a ``functools.lru_cache``-decorated function (it holds no container
    this checker sees),
  * or an explicitly documented single-writer path, suppressed in place
    with ``# repro_torch: ignore[shared-state-safety]`` and a reason.

Import-time initialization is single-threaded and allowed; the checker
flags only mutations inside functions, at request time.  Instance state
(``self._buckets``) is owned by its object and out of scope.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import AnalysisContext, Checker, SourceFile, call_name, register

WATCHED_PREFIXES = ("src/repro_torch/serve/", "src/repro_torch/dse/")
MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter"}
SANCTIONED_CTORS = {"IdentityKeyedCache", "WallTimeMemo"}
MUTATING_METHODS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "clear", "setdefault", "extend", "insert", "remove", "discard",
}


def _module_level_containers(sf: SourceFile) -> dict[str, tuple[int, bool]]:
    """name -> (lineno, sanctioned) for module-level mutable bindings."""
    out: dict[str, tuple[int, bool]] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        mutable = sanctioned = False
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
                              ast.SetComp)):
            mutable = True
        elif isinstance(value, ast.Call):
            ctor = (call_name(value) or "").rsplit(".", 1)[-1]
            mutable = ctor in MUTABLE_CTORS or ctor in SANCTIONED_CTORS
            sanctioned = ctor in SANCTIONED_CTORS
        if not mutable:
            continue
        for t in targets:
            # dunders (__all__ etc.) are module metadata, not shared state
            if isinstance(t, ast.Name) and not t.id.startswith("__"):
                out[t.id] = (node.lineno, sanctioned)
    return out


def _mutation(node: ast.AST, live: set[str]) -> tuple[str | None, str]:
    """(container name, how) when ``node`` mutates one of ``live``."""
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and \
            isinstance(node.ctx, (ast.Store, ast.Del)):
        return node.value.id, "item assignment"
    if isinstance(node, ast.AugAssign):
        base = node.target.value if isinstance(node.target, ast.Subscript) else node.target
        if isinstance(base, ast.Name):
            return base.id, "augmented assignment"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name) and node.func.attr in MUTATING_METHODS:
        return node.func.value.id, f".{node.func.attr}()"
    if isinstance(node, ast.Global):
        for nm in node.names:
            if nm in live:
                return nm, "global rebinding"
    return None, ""


@register
class SharedStateSafety(Checker):
    check_id = "shared-state-safety"
    description = (
        "Module-level mutable containers in repro_torch.serve/repro_torch.dse may only be "
        "mutated via IdentityKeyedCache/WallTimeMemo/lru_cache or documented single-writer paths"
    )

    def run(self, ctx: AnalysisContext) -> None:
        audited: dict[str, list[str]] = {}
        for sf in ctx.files:
            if not sf.path.startswith(WATCHED_PREFIXES):
                continue
            containers = _module_level_containers(sf)
            if containers:
                audited[sf.module] = sorted(containers)
            unsanctioned = {n for n, (_, ok) in containers.items() if not ok}
            if unsanctioned:
                self._check_mutations(sf, unsanctioned)
        self.facts = {"watched": list(WATCHED_PREFIXES), "containers": audited}

    def _check_mutations(self, sf: SourceFile, names: set[str]) -> None:
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # names shadowed by a parameter are not the module container
            live = names - {a.arg for a in fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs}
            for node in ast.walk(fn) if live else ():
                target, how = _mutation(node, live)
                if target in live:
                    self.emit(
                        sf, node,
                        f"module-level container {target!r} mutated at request time ({how}) in "
                        f"{fn.name!r}; route shared state through IdentityKeyedCache/lru_cache "
                        "or document the single writer and suppress",
                    )
