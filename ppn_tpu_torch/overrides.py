"""Dotted-path config overrides: ``--set data.rotate_deg=20`` (a copy of
``ppn_tpu/configs/overrides.py``).

A generic dotted-path override rebuilds the frozen config tree with
``dataclasses.replace``, so every knob stays reachable from the CLI without
a bespoke flag, and ``__post_init__`` validation still runs on the rebuilt
nodes.
"""

from __future__ import annotations

import ast
import dataclasses
import typing
from typing import Any, Sequence


def _coerce(value: str, field_type: Any) -> Any:
    """Parse `value` according to the dataclass field's annotation."""
    origin = typing.get_origin(field_type)
    if field_type is bool:
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    if field_type is int:
        return int(value)
    if field_type is float:
        return float(value)
    if field_type is str:
        return value
    if origin in (tuple, list) or field_type in (tuple, list):
        parsed = ast.literal_eval(value)
        return tuple(parsed) if (origin is tuple or field_type is tuple) \
            else list(parsed)
    # Optional[...] and anything else: best-effort literal, else raw string.
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(cfg: Any, assignments: Sequence[str]) -> Any:
    """Return a copy of the (frozen, nested) dataclass `cfg` with each
    ``path.to.field=value`` assignment applied. Unknown paths raise."""
    for a in assignments:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        path, value = a.split("=", 1)
        cfg = _set_path(cfg, path.strip().split("."), value.strip(), path)
    return cfg


def _set_path(node: Any, parts: Sequence[str], value: str, full: str) -> Any:
    if not dataclasses.is_dataclass(node):
        raise ValueError(f"{full}: {parts[0]!r} is not a config node")
    fields = {f.name: f for f in dataclasses.fields(node)}
    head = parts[0]
    if head not in fields:
        raise ValueError(
            f"{full}: unknown field {head!r} on {type(node).__name__} "
            f"(has: {', '.join(sorted(fields))})")
    if len(parts) == 1:
        ftype = fields[head].type
        if isinstance(ftype, str):  # from __future__ annotations
            ftype = typing.get_type_hints(type(node)).get(head, str)
        return dataclasses.replace(node, **{head: _coerce(value, ftype)})
    child = _set_path(getattr(node, head), parts[1:], value, full)
    return dataclasses.replace(node, **{head: child})
