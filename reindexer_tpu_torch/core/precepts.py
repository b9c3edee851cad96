"""Atomic on-update functions ("precepts").

Reference: core/function/function_parser.cc (FunctionParser::Parse),
core/function/function.cc:27-30 (supported functions now/serial),
core/namespace/namespaceimpl.cc:4191-4257 (setFieldsBasedOnPrecepts +
GetSerial — the serial counter persists in namespace meta under
"_SERIAL_<field>", type_consts.h:427), readme.md:1854-1861.

Grammar: ``"<field>=<func>([arg])"`` or ``"<field>=<literal>"``. Precepts
execute under the namespace lock at item-modify time, so they are
consistent under concurrency:

- ``serial()`` — per-field auto-increment, persisted in namespace meta
  (key ``_SERIAL_<field>``, initial value 1) so it survives restarts.
- ``now([sec|msec|usec|nsec])`` — current timestamp; ``sec`` by default.
- ``skip_embedding()`` — consumed by the auto-embedding layer
  (reference itemimpl.cc:555-575); never reaches the namespace.

Like the reference, precepts are rejected on array and composite index
fields (namespaceimpl.cc:4210-4216).
"""
from __future__ import annotations

import re
import time
from typing import Any, Optional

from .errors import LogicError, ParamsError

SERIAL_PREFIX = "_SERIAL_"   # reference type_consts.h:427 kSerialPrefix

_PRECEPT_RE = re.compile(
    r"^\s*(?P<field>[\w.*]+)\s*=\s*(?P<value>.*\S)\s*$")
_FUNC_RE = re.compile(r"^(?P<name>[A-Za-z_]\w*)\s*\(\s*(?P<args>[^)]*)\s*\)$")

_NOW_UNITS = {"": 1, "sec": 1, "msec": 1_000, "usec": 1_000_000,
              "nsec": 1_000_000_000}


def parse_precept(precept: str) -> tuple[str, Optional[str], list[str], Any]:
    """-> (field, func_name | None, func_args, literal_value).

    ``func_name`` is None for literal-value precepts ("field=42")."""
    m = _PRECEPT_RE.match(precept)
    if not m:
        raise ParamsError(f"bad precept '{precept}': expected field=func()")
    field, value = m.group("field"), m.group("value")
    fm = _FUNC_RE.match(value)
    if fm:
        args = [a.strip() for a in fm.group("args").split(",") if a.strip()]
        return field, fm.group("name").lower(), args, None
    return field, None, [], value


def eval_function(ns, name: str, args: list[str], field: str) -> Any:
    """Evaluate now()/serial() against a namespace (caller holds ns.lock)."""
    if name == "now":
        unit = args[0].lower() if args else "sec"
        if unit not in _NOW_UNITS:
            raise ParamsError(f"now(): unknown unit '{unit}'")
        return int(time.time() * _NOW_UNITS[unit])
    if name == "serial":
        return next_serial(ns, field)
    raise ParamsError(f"Function '{name}' is not supported")


def next_serial(ns, field: str) -> int:
    """Reference NamespaceImpl::GetSerial (namespaceimpl.cc:4243-4257):
    counter persists in namespace meta so it survives restarts."""
    key = SERIAL_PREFIX + field
    prev = ns.get_meta(key)
    counter = int(prev) + 1 if prev else 1
    ns.put_meta(key, str(counter))
    return counter


def apply_precepts(ns, doc: dict, precepts: list[str]) -> None:
    """Mutate ``doc`` in place per the precept list (reference semantics:
    the computed values are written back into the passed item). Caller
    must hold ns.lock."""
    from .payload import set_json_path

    for precept in precepts:
        field, func, args, literal = parse_precept(precept)
        if func == "skip_embedding":
            continue     # handled by the embedding layer
        idef = next((d for d in ns.payload_type.indexes if d.name == field
                     or field in d.json_paths), None)
        if idef is not None:
            if idef.opts.is_array:
                raise LogicError(
                    f"Precepts are not allowed for array fields ('{field}')")
            if idef.is_composite:
                raise LogicError(
                    f"Precepts are not allowed for composite indexes "
                    f"('{field}')")
        if func is not None:
            value = eval_function(ns, func, args, field)
        else:
            value = _coerce(literal)
        path = idef.json_paths[0] if idef is not None else field
        set_json_path(doc, path, value)


def _coerce(text: str) -> Any:
    if len(text) >= 2 and text[0] in "'\"" and text[-1] == text[0]:
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def skip_embedding_fields(precepts: Optional[list[str]]):
    """-> (skip_all, {field,...}) for skip_embedding precepts
    (reference itemimpl.cc:555-575)."""
    if not precepts:
        return False, set()
    skip_all, fields = False, set()
    for p in precepts:
        field, func, _, _ = parse_precept(p)
        if func == "skip_embedding":
            if field == "*":
                skip_all = True
            else:
                fields.add(field)
    return skip_all, fields
