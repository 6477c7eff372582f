"""Config helpers: the ``"auto"`` placeholder and building a config group
from a dict.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``.  The JAX package
builds its groups on pydantic; the port uses plain dataclasses (the machine
with the card has no pydantic) with the same tolerance of keys a group does
not know: they are kept in ``extra`` and have no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

AUTO = "auto"

G = TypeVar("G")


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value == AUTO


def group_from_dict(cls: Type[G], data: Any, where: str) -> G:
    """``cls(**known keys)``; unknown keys go to the group's ``extra`` dict.
    ``data`` must be a dict (or None for the defaults)."""
    if data is None:
        return cls()
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise TypeError(f"config group {where!r} must be an object, got "
                        f"{type(data).__name__}")
    names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
    known = {k: v for k, v in data.items() if k in names}
    extra: Dict[str, Any] = {k: v for k, v in data.items() if k not in names}
    obj = cls(**known)
    if "extra" in {f.name for f in dataclasses.fields(cls)}:
        obj.extra = extra
    return obj
