"""Config dataclass hydration (the part of ``pylidar_slam_tpu.config`` the
ported slice needs): ``MISSING`` placeholders and ``dataclass_from_dict``.

The YAML composer and the registries stay in the JAX package until the CLI
is ported (ROADMAP.md A.19).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type

MISSING = "???"


def instantiate_defaults(cls: Type) -> Any:
    """Instantiates a config dataclass filling required fields with MISSING."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            continue
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            continue
        kwargs[f.name] = MISSING
    return cls(**kwargs)


def dataclass_from_dict(cls: Type, data: Optional[Dict[str, Any]], **extra) -> Any:
    """Hydrates a config dataclass from a dict, ignoring unknown keys;
    missing required fields become MISSING."""
    data = dict(data or {})
    data.update(extra)
    field_names = {f.name for f in dataclasses.fields(cls)}
    obj = instantiate_defaults(cls)
    for k, v in data.items():
        if k in field_names:
            setattr(obj, k, v)
    return obj
