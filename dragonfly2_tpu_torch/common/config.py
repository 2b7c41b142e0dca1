"""Typed config: dataclass configs loaded from YAML or JSON plus env overlay.

Counterpart of ``dragonfly2_tpu/common/config.py`` (the reference's
cobra+viper plumbing, ``cmd/dependency/dependency.go`` initConfig): each
service defines nested dataclasses; ``load_config`` merges file -> dict ->
dataclass with unknown-key errors, then calls ``validate()`` hooks bottom
up. YAML is read by the reference's standard-library subset (maps, block
lists, scalars); the reference hands YAML to PyYAML when it is installed,
which the card's machine does not have.

Every service config takes every key of the reference's, with the
reference's default, so a reference deployment's file loads. Each config
module keeps a table (``KEY_CLASSES``) that puts each key in one class:
``WIRED`` (the subsystem is here and the key reaches it), ``INERT`` (the
reference declares the key and reads it nowhere, so nothing reads it here
either) or ``unported(item)`` (the subsystem is not ported yet: the key
loads, and a value other than its default is refused at start by name,
naming the ROADMAP item, through ``refuse_unported``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
import typing
from typing import Any, Type, TypeVar

_UNION_TYPES = (typing.Union, types.UnionType)

T = TypeVar("T")


class ConfigError(ValueError):
    pass


WIRED = "wired"
INERT = "inert"


def unported(item: str) -> str:
    """The class of a key whose subsystem waits for ROADMAP Queue 1
    ``item``."""
    return f"unported:{item}"


def key_value(cfg: Any, key: str) -> Any:
    """The value at a dotted key path (``"upload.rate_limit_bps"``)."""
    for part in key.split("."):
        cfg = getattr(cfg, part)
    return cfg


def unported_set(cfg: Any, classes: dict[str, str]) -> list[tuple[str, str]]:
    """``(key, item)`` for each unported key set to other than its
    default."""
    default = type(cfg)()
    return [(key, cls.split(":", 1)[1]) for key, cls in classes.items()
            if cls.startswith("unported:")
            and key_value(cfg, key) != key_value(default, key)]


def refuse_unported(cfg: Any, classes: dict[str, str]) -> None:
    """Raise ``ConfigError`` naming every unported key that is set."""
    bad = unported_set(cfg, classes)
    if bad:
        raise ConfigError(
            f"{type(cfg).__name__}: not ported to this package yet: "
            + ", ".join(f"{key} (ROADMAP Queue 1 item {item})"
                        for key, item in bad))


def _build(cls: Type[T], data: dict[str, Any], path: str) -> T:
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{path}: {cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for key, value in data.items():
        if key not in fields:
            raise ConfigError(f"{path}: unknown key {key!r} for {cls.__name__}")
        kwargs[key] = _coerce(hints.get(key, fields[key].type), value,
                              f"{path}.{key}")
    return cls(**kwargs)


def _coerce(ftype: Any, value: Any, path: str) -> Any:
    origin = typing.get_origin(ftype)
    if origin in _UNION_TYPES:  # Optional[X]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        if len(args) == 1:
            return _coerce(args[0], value, path)
        return value
    if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
        return _build(ftype, value, path)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        elem = (typing.get_args(ftype) or (Any,))[0]
        seq = [_coerce(elem, v, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if origin is dict and isinstance(value, dict):
        return value
    if ftype is float and isinstance(value, int):
        return float(value)
    return value


def from_dict(cls: Type[T], data: dict[str, Any]) -> T:
    cfg = _build(cls, data, cls.__name__)
    _validate_tree(cfg)
    return cfg


def _validate_tree(obj: Any) -> None:
    if not dataclasses.is_dataclass(obj):
        return
    for f in dataclasses.fields(obj):
        _validate_tree(getattr(obj, f.name))
    validate = getattr(obj, "validate", None)
    if callable(validate):
        validate()


def load_config(cls: Type[T], config_path: str | None = None,
                overrides: dict[str, Any] | None = None) -> T:
    data: dict[str, Any] = {}
    if config_path:
        with open(config_path) as f:
            text = f.read()
        if config_path.endswith((".yaml", ".yml")):
            data = _parse_yaml(text)
        else:
            data = json.loads(text)
    if overrides:
        data = _deep_merge(data, overrides)
    return from_dict(cls, data)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_yaml(text: str) -> dict[str, Any]:
    """An indentation-based YAML subset (maps, block lists, scalars),
    enough for the services' config files."""
    lines = [ln for ln in text.splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]

    def walk(i: int, indent: int, container: Any) -> int:
        while i < len(lines):
            ln = lines[i]
            ind = len(ln) - len(ln.lstrip())
            if ind <= indent:
                return i
            content = ln.strip()
            if content.startswith("- "):
                if not isinstance(container, list):
                    raise ConfigError(f"list item outside list: {ln!r}")
                container.append(_scalar(content[2:].strip()))
                i += 1
                continue
            key, sep, rest = content.partition(":")
            if not sep:
                raise ConfigError(f"cannot parse line: {ln!r}")
            key, rest = key.strip(), rest.strip()
            if rest == "":
                # block value: list if the first child line is "- ", else map
                sub: Any = {}
                if i + 1 < len(lines):
                    nxt = lines[i + 1]
                    nind = len(nxt) - len(nxt.lstrip())
                    if nind > ind and nxt.strip().startswith("- "):
                        sub = []
                container[key] = sub
                i = walk(i + 1, ind, sub)
                continue
            container[key] = _scalar(rest)
            i += 1
        return i

    root: dict[str, Any] = {}
    walk(0, -1, root)
    return root


# the reference's name for the subset parser (its ``_parse_yaml`` tries
# PyYAML first; the port has only the subset, known difference 7)
_mini_yaml = _parse_yaml


def _scalar(s: str) -> Any:
    if s.startswith(("'", '"')) and s.endswith(s[0]) and len(s) >= 2:
        return s[1:-1]
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


# DF_* variables that are not config-field overrides (read elsewhere: the
# workdir default, the topology's injected zone, coords and pod). The
# launchers fold every other DF_* variable into the config tree, where an
# unknown key is an error.
_ENV_NON_CONFIG = {"DF_WORKDIR", "DF_ZONE", "DF_DEFAULT_ZONE",
                   "DF_ICI_COORDS", "DF_POD_ID",
                   "DF_TOPOLOGY_PROBE_TIMEOUT_S", "DF_TOPOLOGY_WEDGE_CACHE"}


def env_overrides(prefix: str = "DF_") -> dict[str, Any]:
    """DF_A__B=2 -> {"a": {"b": 2}} (double underscore nests)."""
    out: dict[str, Any] = {}
    for key, val in os.environ.items():
        if not key.startswith(prefix) or key in _ENV_NON_CONFIG:
            continue
        path = key[len(prefix):].lower().split("__")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _scalar(val)
    return out
