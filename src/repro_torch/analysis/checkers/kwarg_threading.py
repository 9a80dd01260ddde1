"""kwarg-threading: dispatch wrappers must forward the knobs they accept.

When a wrapper accepts one of the port's threaded knobs (``ordering=``,
``device=``, ``rows_per_block=``, ``tile_nnz=``) and calls a function that
also accepts that knob, the call must mention it: as ``knob=...``, inside
any argument expression, or via ``**kwargs``.  Otherwise the callee
silently runs on its default while the caller believes the knob took
effect.  ``device`` takes the place of the JAX package's ``backend``: every
port entry point takes ``device=``, default ``"cuda"``, so a wrapper that
drops it runs its callee on the card when the caller asked for the CPU, or
raises where no card is.

A knob counts as forwarded under another name too: a local bound to it, or
to a device resolver's result over it (``dev = resolve_device(device)``),
and any attribute named after it (``self.device``).  The port resolves a
device once at the top of a wrapper and passes the result on.

The callee signature index covers the port's sources: top-level
functions, class constructors (``__init__``) and methods, indexed per
module; call sites resolve through ``import``/``from``-import bindings
(module aliases included) and ``self.<method>`` within a class.  Call
targets that do not resolve are skipped: the checker refuses to guess.

A deliberate non-forward (a prebuilt ``plan=`` that already encodes the
geometry, a device taken from the tensors themselves) is suppressed in
place with ``# repro_torch: ignore[kwarg-threading]`` and a reason.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    AnalysisContext,
    Checker,
    SourceFile,
    call_name,
    names_in,
    register,
)

#: The threaded knobs.
WATCHED = ("ordering", "device", "rows_per_block", "tile_nnz")
#: Calls whose result is the device their argument names.
DEVICE_RESOLVERS = ("resolve_device", "device", "rank_device")


def _mentions(node: ast.AST, names: set[str], knob: str) -> bool:
    """``node`` loads one of ``names`` or reads an attribute named ``knob``."""
    return bool(names_in(node) & names) or any(
        isinstance(n, ast.Attribute) and n.attr == knob for n in ast.walk(node))


def _aliases(fn: ast.FunctionDef, knob: str) -> set[str]:
    """``knob`` and the locals of ``fn`` bound to it: ``x = knob``, or
    ``x = resolve_device(knob)`` (any of ``DEVICE_RESOLVERS``), to a fixpoint."""
    names = {knob}
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    grew = True
    while grew:
        grew = False
        for node in assigns:
            value = node.value
            if isinstance(value, ast.Call):
                if (call_name(value) or "").rsplit(".", 1)[-1] not in DEVICE_RESOLVERS:
                    continue
                if not any(_mentions(a, names, knob) for a in value.args):
                    continue
            elif not _mentions(value, names, knob) or not isinstance(
                    value, (ast.Name, ast.Attribute)):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id not in names:
                    names.add(t.id)
                    grew = True
    return names


def _params_of(fn: ast.FunctionDef) -> set[str]:
    return {
        a.arg
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        if a.arg not in ("self", "cls")
    }


class _ModuleIndex:
    """Signatures of one module's top-level callables."""

    def __init__(self, sf: SourceFile) -> None:
        self.module = sf.module
        self.functions: dict[str, set[str]] = {}
        self.methods: dict[str, dict[str, set[str]]] = {}
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = _params_of(node)
            elif isinstance(node, ast.ClassDef):
                meths: dict[str, set[str]] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        meths[item.name] = _params_of(item)
                self.methods[node.name] = meths
                if "__init__" in meths:
                    # constructing the class = calling __init__
                    self.functions[node.name] = meths["__init__"]


def _import_bindings(sf: SourceFile) -> dict[str, tuple[str, str | None]]:
    """local name -> (module, symbol|None).  ``None`` symbol = the module
    itself (attribute access resolves the symbol at the call site).
    Function-scope imports are included — the repo uses deferred imports
    heavily for circular-import control."""
    out: dict[str, tuple[str, str | None]] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                local = alias.asname or alias.name
                out[local] = (node.module, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                if alias.asname:
                    out[local] = (alias.name, None)
                else:
                    out[local] = (alias.name.split(".")[0], None)
    return out


@register
class KwargThreading(Checker):
    check_id = "kwarg-threading"
    description = (
        "Wrappers accepting ordering=/device=/rows_per_block=/tile_nnz= "
        "must forward them to every resolvable callee that accepts them"
    )

    def run(self, ctx: AnalysisContext) -> None:
        index: dict[str, _ModuleIndex] = {}
        for sf in ctx.under("src/"):
            index[sf.module] = _ModuleIndex(sf)
        audited_wrappers = 0
        audited_calls = 0
        for sf in ctx.under("src/"):
            bindings = _import_bindings(sf)
            local = index[sf.module]
            for node in sf.tree.body:
                fns: list[tuple[ast.FunctionDef, str | None]] = []
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns.append((node, None))
                elif isinstance(node, ast.ClassDef):
                    fns.extend(
                        (item, node.name)
                        for item in node.body
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    )
                for fn, cls in fns:
                    watched = _params_of(fn) & set(WATCHED)
                    if not watched:
                        continue
                    audited_wrappers += 1
                    audited_calls += self._check_wrapper(
                        sf, fn, cls, watched, bindings, index, local
                    )
        self.facts = {
            "watched": list(WATCHED),
            "wrappers_audited": audited_wrappers,
            "calls_audited": audited_calls,
        }

    def _resolve_callee(
        self,
        call: ast.Call,
        cls: str | None,
        bindings: dict[str, tuple[str, str | None]],
        index: dict[str, _ModuleIndex],
        local: _ModuleIndex,
    ) -> tuple[str, set[str]] | None:
        """(display name, callee params) or None if unresolvable."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in local.functions:
                return f.id, local.functions[f.id]
            if f.id in bindings:
                mod, sym = bindings[f.id]
                mi = index.get(mod)
                if mi and sym and sym in mi.functions:
                    return f"{mod}.{sym}", mi.functions[sym]
            return None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base = f.value.id
            if base == "self" and cls is not None:
                meths = local.methods.get(cls, {})
                if f.attr in meths:
                    return f"self.{f.attr}", meths[f.attr]
                return None
            if base in bindings:
                mod, sym = bindings[base]
                target_mod = mod if sym is None else f"{mod}.{sym}"
                mi = index.get(target_mod)
                if mi and f.attr in mi.functions:
                    return f"{target_mod}.{f.attr}", mi.functions[f.attr]
        return None

    def _check_wrapper(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        cls: str | None,
        watched: set[str],
        bindings: dict[str, tuple[str, str | None]],
        index: dict[str, _ModuleIndex],
        local: _ModuleIndex,
    ) -> int:
        checked = 0
        aliases = {p: _aliases(fn, p) for p in watched}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = self._resolve_callee(node, cls, bindings, index, local)
            if resolved is None:
                continue
            callee_name, callee_params = resolved
            shared = watched & callee_params
            if not shared:
                continue
            checked += 1
            has_splat = any(kw.arg is None for kw in node.keywords)
            if has_splat:
                continue
            mentioned: set[str] = set()
            for kw in node.keywords:
                if kw.arg in shared:
                    mentioned.add(kw.arg)
            values = list(node.args) + [kw.value for kw in node.keywords]
            for p in sorted(shared - mentioned):
                if any(_mentions(v, aliases[p], p) for v in values):
                    continue
                self.emit(
                    sf, node,
                    f"{fn.name!r} accepts {p!r} but its call to {callee_name} "
                    f"(which also accepts {p!r}) does not forward it: the "
                    "callee silently runs on its default",
                )
        return checked
