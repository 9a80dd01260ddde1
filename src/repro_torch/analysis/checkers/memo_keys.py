"""memo-key-completeness: cache keys must cover every key-relevant field.

A memo key that misses a field aliases two logical entries: a tuner's
``WallTimeMemo.key`` that omitted ``reps`` answered a 20-rep request with a
3-rep median, and a geometry field missing from ``CacheGeometry``'s key
would alias ``HitRateCache`` entries.  The port keeps its own memos
(``core/memo.py``, the tuner's ``WallTimeMemo``, the DSE's caches), so it
is held to the same four rules as the JAX package:

  1. **KEY_FIELDS completeness**: a dataclass declaring a ``KEY_FIELDS``
     tuple lists every dataclass field in it, and nothing else.
  2. **key-builder completeness**: a function named ``key`` (or
     ``*_key``) that returns a tuple mentions every parameter in the
     returned expression; a parameter accepted but not hashed is exactly
     the ``reps`` bug.
  3. **get/put key symmetry**: at every ``IdentityKeyedCache`` binding,
     the key expressions passed to ``.get(anchor, key)`` equal those passed
     to ``.put(anchor, key, value)``; a memo that stores under another key
     than it looks up never hits.
  4. **hash-complete key dataclasses**: a frozen dataclass whose name marks
     it as a key (``*Signature``, ``*Geometry``, ``*Config``, ``*Key``)
     excludes no field from equality or hash (``compare=False`` /
     ``hash=False``).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    AnalysisContext,
    Checker,
    SourceFile,
    call_name,
    dotted_name,
    names_in,
    register,
)

KEY_CLASS_RE = ("Signature", "Geometry", "Config", "Key")


def _is_dataclass(cls: ast.ClassDef) -> tuple[bool, bool]:
    """(is_dataclass, frozen)"""
    for dec in cls.decorator_list:
        name = call_name(dec) if isinstance(dec, ast.Call) else None
        if name is None and isinstance(dec, (ast.Name, ast.Attribute)):
            from repro_torch.analysis.core import dotted_name

            name = dotted_name(dec)
        if name and name.rsplit(".", 1)[-1] == "dataclass":
            frozen = False
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                        frozen = bool(kw.value.value)
            return True, frozen
    return False, False


def _dataclass_fields(cls: ast.ClassDef) -> list[ast.AnnAssign]:
    """Annotated class-level assignments = dataclass fields (ClassVar and
    plain ``NAME = ...`` class attributes like KEY_FIELDS are not fields)."""
    out = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            ann = ast.unparse(node.annotation)
            if "ClassVar" in ann:
                continue
            out.append(node)
    return out


@register
class MemoKeyCompleteness(Checker):
    check_id = "memo-key-completeness"
    description = (
        "Cache-key dataclasses hash over all fields (KEY_FIELDS complete, "
        "no compare=False), key() builders use every parameter, and "
        "IdentityKeyedCache get/put key expressions match"
    )

    def run(self, ctx: AnalysisContext) -> None:
        audited_classes: list[str] = []
        audited_builders: list[str] = []
        audited_caches: list[str] = []
        # Every scanned file: memo keys built by test helpers and the card
        # check obey the same contract; the fixtures stay waived.
        for sf in ctx.scannable():
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef):
                    self._check_class(sf, node, audited_classes)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node.name == "key" or node.name.endswith("_key"):
                        if self._check_key_builder(sf, node):
                            audited_builders.append(f"{sf.module}.{node.name}")
            audited_caches.extend(self._check_identity_caches(sf))
        self.facts = {
            "key_classes": audited_classes,
            "key_builders": audited_builders,
            "identity_caches": audited_caches,
        }

    # -- rules 1 and 4 -------------------------------------------------------

    def _check_class(
        self, sf: SourceFile, cls: ast.ClassDef, audited: list[str]
    ) -> None:
        is_dc, frozen = _is_dataclass(cls)
        if not is_dc:
            return
        fields = _dataclass_fields(cls)
        field_names = [f.target.id for f in fields]  # type: ignore[union-attr]

        key_fields_node = None
        for node in cls.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "KEY_FIELDS"
            ):
                key_fields_node = node
        if key_fields_node is not None:
            audited.append(f"{sf.module}.{cls.name}")
            declared: set[str] = set()
            if isinstance(key_fields_node.value, (ast.Tuple, ast.List)):
                declared = {
                    e.value
                    for e in key_fields_node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                }
            missing = [f for f in field_names if f not in declared]
            for f in missing:
                self.emit(
                    sf, key_fields_node,
                    f"{cls.name}.KEY_FIELDS omits field {f!r}; a key-relevant "
                    "field missing from the memo key silently aliases cache "
                    "entries",
                )
            stale = sorted(declared - set(field_names))
            for f in stale:
                self.emit(
                    sf, key_fields_node,
                    f"{cls.name}.KEY_FIELDS names {f!r} which is not a "
                    "dataclass field (stale key declaration)",
                )

        if frozen and (
            key_fields_node is not None
            or any(cls.name.endswith(s) for s in KEY_CLASS_RE)
        ):
            if key_fields_node is None:
                audited.append(f"{sf.module}.{cls.name}")
            for f in fields:
                if not isinstance(f.value, ast.Call):
                    continue
                if (call_name(f.value) or "").rsplit(".", 1)[-1] != "field":
                    continue
                for kw in f.value.keywords:
                    if kw.arg in ("compare", "hash") and isinstance(
                        kw.value, ast.Constant
                    ) and kw.value.value is False:
                        self.emit(
                            sf, f,
                            f"{cls.name}.{f.target.id} sets {kw.arg}=False; "  # type: ignore[union-attr]
                            "a key dataclass excluded field is invisible to "
                            "every dict/memo keyed on the class",
                        )

    # -- rule 2 --------------------------------------------------------------

    def _check_key_builder(self, sf: SourceFile, fn: ast.FunctionDef) -> bool:
        params = [
            a.arg
            for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
            if a.arg not in ("self", "cls")
        ]
        returns = [
            n for n in ast.walk(fn)
            if isinstance(n, ast.Return) and n.value is not None
        ]
        # Only audit tuple-building keys: a ``key()`` computing something
        # else (or with no parameters) has nothing to omit.
        tuple_returns = [
            r for r in returns
            if isinstance(r.value, ast.Tuple)
            or (isinstance(r.value, ast.Call)
                and (call_name(r.value) or "") == "tuple")
            or (isinstance(r.value, ast.BinOp)
                and isinstance(r.value.op, ast.Add))
        ]
        if not params or not tuple_returns:
            return False
        used: set[str] = set()
        for r in tuple_returns:
            used |= names_in(r.value)
        for p in params:
            if p not in used:
                self.emit(
                    sf, fn,
                    f"key builder {fn.name!r} accepts parameter {p!r} but the "
                    "returned key never uses it — two calls differing only in "
                    f"{p!r} share a memo entry (the WallTimeMemo 'reps' bug)",
                )
        return True

    # -- rule 3 --------------------------------------------------------------

    def _check_identity_caches(self, sf: SourceFile) -> list[str]:
        """get/put key-expression symmetry per IdentityKeyedCache binding."""
        cache_names: set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = (call_name(node.value) or "").rsplit(".", 1)[-1]
                if ctor == "IdentityKeyedCache":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            cache_names.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            cache_names.add(t.attr)
        if not cache_names:
            return []

        gets: dict[str, dict[str, ast.Call]] = {n: {} for n in cache_names}
        puts: dict[str, dict[str, ast.Call]] = {n: {} for n in cache_names}
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "put")
                    and len(node.args) >= 2):
                continue
            base = node.func.value
            base_name = base.id if isinstance(base, ast.Name) else (
                base.attr if isinstance(base, ast.Attribute) else None
            )
            if base_name not in cache_names:
                continue
            key_repr = ast.unparse(node.args[1])
            (gets if node.func.attr == "get" else puts)[base_name][key_repr] = node
        for name in sorted(cache_names):
            for key_repr, call in sorted(puts[name].items()):
                if gets[name] and key_repr not in gets[name]:
                    self.emit(
                        sf, call,
                        f"cache {name!r}: .put() keys on {key_repr} but no "
                        f".get() uses that expression (lookups use "
                        f"{sorted(gets[name])}); asymmetric keys never hit",
                    )
            for key_repr, call in sorted(gets[name].items()):
                if puts[name] and key_repr not in puts[name]:
                    self.emit(
                        sf, call,
                        f"cache {name!r}: .get() keys on {key_repr} but no "
                        f".put() stores under it (stores use "
                        f"{sorted(puts[name])}); asymmetric keys never hit",
                    )
        return [f"{sf.module}.{n}" for n in sorted(cache_names)]
