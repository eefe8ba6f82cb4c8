"""Configuration: the YAML tree under ``config/``, CLI overrides and config
dataclasses (port of ``pylidar_slam_tpu.config``).

* a reader for the YAML subset the ``config/`` tree uses (comments,
  ``# @package _group_`` group files, scalars by YAML 1.1's implicit rules,
  nested block maps, block and flow lists, ``defaults:`` lists) and a
  writer for the plain data the runner records; no PyYAML on any platform;
* CLI overrides: ``group=option``, ``a.b.c=value``, ``+new.key=value``;
* ``${env:VAR}`` / ``${now:%fmt}`` interpolation and ``???`` (MISSING);
* dataclass hydration tolerating missing fields, and the string-keyed
  ``Registry`` of implementations.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type

MISSING = "???"


# ----------------------------------------------------------------------------
# Dataclass hydration
# ----------------------------------------------------------------------------

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


def to_dict(node: Any) -> Dict[str, Any]:
    """A config dataclass (type or instance) or mapping as a plain dict."""
    if dataclasses.is_dataclass(node) and isinstance(node, type):
        node = instantiate_defaults(node)
    if dataclasses.is_dataclass(node):
        node = {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
    if isinstance(node, dict):
        return {k: to_dict(v) if isinstance(v, dict) or dataclasses.is_dataclass(v)
                else v for k, v in node.items()}
    raise TypeError(f"Cannot convert {type(node)} to config dict")


# ----------------------------------------------------------------------------
# YAML subset: reader
# ----------------------------------------------------------------------------

class YAMLError(ValueError):
    """Text outside the YAML subset this reader accepts."""


# YAML 1.1 implicit scalar types, as PyYAML's SafeLoader resolves them.
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)


def _sexagesimal(sign: int, text: str, cast):
    value = cast(0)
    base = 1
    for digit in reversed(text.split(":")):
        value += cast(digit) * base
        base *= 60
    return sign * value


def _resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar by YAML 1.1's implicit resolution."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return _sexagesimal(sign, v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal(sign, v, float)
        return sign * float(v)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _read_quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, end index)."""
    quote = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if quote == "'":
            if c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
        else:
            if c == '"':
                return "".join(out), j + 1
            if c == "\\":
                nxt = text[j + 1:j + 2]
                if nxt in ("x", "u", "U"):
                    width = {"x": 2, "u": 4, "U": 8}[nxt]
                    out.append(chr(int(text[j + 2:j + 2 + width], 16)))
                    j += 2 + width
                    continue
                if nxt not in _ESCAPES:
                    raise YAMLError(f"unknown escape \\{nxt} in {text!r}")
                out.append(_ESCAPES[nxt])
                j += 2
                continue
        out.append(c)
        j += 1
    raise YAMLError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a '#' at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            _, i = _read_quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Flow collections (``[a, b]``, ``{k: v}``) and the scalars in them."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def value(self) -> Any:
        self._skip()
        c = self.text[self.i:self.i + 1]
        if c == "[":
            return self._sequence()
        if c == "{":
            return self._mapping()
        if c in ("'", '"'):
            v, self.i = _read_quoted(self.text, self.i)
            return v
        start = self.i
        while self.i < len(self.text):
            c = self.text[self.i]
            if c in ",]}":
                break
            if c == ":" and self.text[self.i + 1:self.i + 2] in (" ", ",", "]", "}", ""):
                break
            self.i += 1
        return _resolve_plain(self.text[start:self.i].strip())

    def _items(self, close: str, item):
        out = []
        self.i += 1
        while True:
            self._skip()
            if self.text[self.i:self.i + 1] == close:
                self.i += 1
                return out
            out.append(item())
            self._skip()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != close:
                raise YAMLError(f"expected ',' or '{close}' in {self.text!r}")

    def _sequence(self) -> list:
        return self._items("]", self.value)

    def _mapping(self) -> dict:
        def pair():
            key = self.value()
            self._skip()
            if self.text[self.i:self.i + 1] != ":":
                raise YAMLError(f"expected ':' in {self.text!r}")
            self.i += 1
            return key, self.value()
        return dict(self._items("}", pair))

    def done(self) -> Any:
        v = self.value()
        self._skip()
        if self.i != len(self.text):
            raise YAMLError(f"trailing text after a value in {self.text!r}")
        return v


def _scalar(text: str) -> Any:
    """An inline block value: a flow collection, a quoted scalar, or a
    plain scalar running to the end of the line."""
    if text[:1] in "[{'\"":
        return _Flow(text).done()
    return _resolve_plain(text)


def _split_key(text: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) when `text` is a ``key: value`` (or ``key:``) entry."""
    if text[:1] in ("'", '"'):
        key, i = _read_quoted(text, 0)
        rest = text[i:].lstrip(" ")
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    if text[:1] in "[{":
        return None
    m = re.search(r":(?: |\t|$)", text)
    if m is None:
        return None
    return _resolve_plain(text[:m.start()].strip()), text[m.end():].strip()


class _Block:
    """Block-structured YAML: indentation-nested maps and ``- `` lists."""

    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs in indentation")
            body = _strip_comment(raw)
            if body.strip() in ("", "---"):
                continue
            self.lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
        self.i = 0

    def document(self) -> Any:
        if not self.lines:
            return None
        v = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            raise YAMLError(f"unexpected indentation at {self.lines[self.i][1]!r}")
        return v

    def node(self, indent: int) -> Any:
        if self.lines[self.i][1].startswith("- ") or self.lines[self.i][1] == "-":
            return self.sequence(indent)
        if _split_key(self.lines[self.i][1]) is None:
            v = _scalar(self.lines[self.i][1])
            self.i += 1
            return v
        return self.mapping(indent)

    def _nested(self, indent: int, allow_same_indent_list: bool) -> Any:
        """The value of an entry with nothing after its ':' (or '-')."""
        if self.i < len(self.lines):
            nxt_indent, nxt = self.lines[self.i]
            if nxt_indent > indent:
                return self.node(nxt_indent)
            if allow_same_indent_list and nxt_indent == indent and \
                    (nxt.startswith("- ") or nxt == "-"):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines) and self.lines[self.i][0] == indent:
            entry = _split_key(self.lines[self.i][1])
            if entry is None:
                raise YAMLError(f"expected 'key: value', got {self.lines[self.i][1]!r}")
            key, rest = entry
            self.i += 1
            out[key] = _scalar(rest) if rest else self._nested(indent, True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines) and self.lines[self.i][0] == indent and \
                (self.lines[self.i][1].startswith("- ") or self.lines[self.i][1] == "-"):
            item = self.lines[self.i][1][1:].lstrip(" ")
            if not item:
                self.i += 1
                out.append(self._nested(indent, False))
                continue
            # the item's content continues at the column after '- '
            inner = indent + len(self.lines[self.i][1]) - len(item)
            self.lines[self.i] = (inner, item)
            out.append(self.node(inner))
        return out


def load_yaml(text: str) -> Any:
    """Parses YAML text in the subset the ``config/`` tree uses."""
    return _Block(text).document()


def load_yaml_file(path) -> Any:
    with open(path) as f:
        return load_yaml(f.read())


# ----------------------------------------------------------------------------
# YAML subset: writer
# ----------------------------------------------------------------------------

def _float_text(v: float) -> str:
    """A float as PyYAML's SafeDumper writes it."""
    if v != v:
        return ".nan"
    if v in (math.inf, -math.inf):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    s = str(v)
    plain_ok = (s and s == s.strip() and "\n" not in s
                and not re.search(r"[:#]\s|\s#|:$|[\[\]{},]", s)
                and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
                and _resolve_plain(s) == s)
    if plain_ok:
        return s
    return "'" + s.replace("'", "''") + "'"


def dump_yaml(data: Any) -> str:
    """Block-style YAML of plain data (dicts, lists, str, int, float, bool,
    None), keys sorted, laid out as PyYAML's ``safe_dump`` lays it out."""
    lines: List[str] = []

    def emit(node, indent: int, prefix: str):
        if isinstance(node, dict) and node:
            first = True
            for k in sorted(node):
                head = (prefix if first else " " * indent) + _scalar_text(k) + ":"
                first = False
                value = node[k]
                if isinstance(value, dict) and value:
                    lines.append(head)
                    emit(value, indent + 2, " " * (indent + 2))
                elif isinstance(value, (list, tuple)) and value:
                    lines.append(head)
                    emit(list(value), indent, " " * indent)
                else:
                    lines.append(head + " " + _inline(value))
        elif isinstance(node, (list, tuple)) and node:
            first = True
            for item in node:
                head = (prefix if first else " " * indent) + "- "
                first = False
                if isinstance(item, (dict, list, tuple)) and item:
                    emit(item, indent + 2, head)
                else:
                    lines.append(head + _inline(item))
        else:
            lines.append(prefix + _inline(node))

    def _inline(v):
        if isinstance(v, dict):
            return "{}"
        if isinstance(v, (list, tuple)):
            return "[]"
        return _scalar_text(v)

    emit(data, 0, "")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------------
# Interpolation
# ----------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{(env|oc\.env|now):([^}]*)\}")


def _interp_value(value: str) -> str:
    def repl(m):
        kind, arg = m.group(1), m.group(2)
        if kind in ("env", "oc.env"):
            parts = [p.strip() for p in arg.split(",")]
            var = parts[0]
            default = parts[1] if len(parts) > 1 else None
            got = os.environ.get(var, default)
            if got is None:
                raise KeyError(f"Environment variable '{var}' is not set "
                               f"(required by config interpolation)")
            return got
        return datetime.datetime.now().strftime(arg)

    return _INTERP_RE.sub(repl, value)


def resolve_interpolations(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: resolve_interpolations(v) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve_interpolations(v) for v in node]
    if isinstance(node, str) and "${" in node:
        return _interp_value(node)
    return node


# ----------------------------------------------------------------------------
# YAML tree composition
# ----------------------------------------------------------------------------

def _deep_set(cfg: Dict[str, Any], dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def _deep_get(cfg: Dict[str, Any], dotted: str, default=None):
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_scalar(text: str) -> Any:
    """Parses a CLI value by the YAML reader's rules; exponent floats
    without a dot ('2e-4'), strings under YAML 1.1, become numbers."""
    try:
        value = load_yaml(text)
    except (YAMLError, IndexError, ValueError):
        return text
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


class ConfigLoader:
    """Loads and composes the YAML config tree (mini-hydra)."""

    def __init__(self, config_path: str):
        self.root = Path(config_path)

    def _load_group_option(self, group: str, option: str) -> Dict[str, Any]:
        """Loads a `group=option` node from its YAML file; a
        '# @package _group_' file's content lands at the group path."""
        yaml_path = self.root / group / f"{option}.yaml"
        if not yaml_path.exists():
            raise FileNotFoundError(
                f"Unknown config option '{option}' for group '{group}' "
                f"(no {yaml_path})")
        return load_yaml_file(yaml_path) or {}

    def compose(self, config_name: str, overrides: Optional[list] = None) -> Dict[str, Any]:
        """Composes the root config + defaults list + CLI overrides."""
        raw = load_yaml_file(self.root / f"{config_name}.yaml") or {}
        defaults = raw.pop("defaults", [])
        cfg: Dict[str, Any] = {}

        # 1. defaults list (group files land at their group path)
        group_choices: Dict[str, str] = {}
        for entry in defaults:
            if isinstance(entry, str):
                continue  # e.g. `_self_`
            (group, option), = entry.items()
            if group.startswith("hydra/"):
                continue  # output-dir templating handled by the runner
            group_choices[group] = option

        # CLI group overrides replace defaults-list choices
        dot_overrides = []
        cli_groups = set()
        for ov in list(overrides or []):
            if "=" not in ov:
                raise ValueError(f"Malformed override '{ov}' (expected key=value)")
            key, value = ov.split("=", 1)
            key = key.lstrip("+")
            if "/" in key or ("." not in key and (self.root / key).is_dir()):
                # group override, e.g. `slam/odometry=icp_odometry`
                group_choices[key] = value
                cli_groups.add(key)
            else:
                dot_overrides.append((key, _parse_scalar(value)))

        # Nested defaults: a group option file may carry its own `defaults`
        # list of subgroup choices (slam/odometry/ct_icp.yaml selects its
        # local_map and alignment); CLI subgroup overrides still win.
        worklist = list(group_choices.items())
        loaded_nodes: Dict[str, Dict[str, Any]] = {}
        while worklist:
            group, option = worklist.pop(0)
            node = self._load_group_option(group, str(option))
            nested = []
            if isinstance(node, dict) and "defaults" in node:
                node = dict(node)
                nested = node.pop("defaults")
            loaded_nodes[group] = node
            for entry in nested:
                if not isinstance(entry, dict):
                    continue
                (sub, sub_opt), = entry.items()
                full = sub if "/" in sub else f"{group}/{sub}"
                if full in cli_groups:
                    continue
                group_choices[full] = sub_opt
                worklist.append((full, sub_opt))

        for group in group_choices:
            path = group.replace("/", ".")
            node = loaded_nodes[group]
            existing = _deep_get(cfg, path, None)
            if isinstance(existing, dict) and isinstance(node, dict):
                # a parent option file's inline keys for a subgroup override
                # the subgroup file's values (hydra's primary-content order)
                node = _deep_merge(node, existing)
            _deep_set(cfg, path, node)

        # 2. the root file's own content merges on top of group defaults
        cfg = _deep_merge(cfg, raw)

        # 3. dotted overrides
        for key, value in dot_overrides:
            _deep_set(cfg, key, value)

        return resolve_interpolations(cfg)


def compose(config_path: str, config_name: str, overrides: Optional[list] = None):
    return ConfigLoader(config_path).compose(config_name, overrides)


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

class Registry:
    """String-discriminated factory: config dict -> (class, config dataclass).

    The config carries a discriminator field (``type`` / ``algorithm`` /
    ``dataset``) selecting the registered implementation.
    """

    def __init__(self, name: str, type_key: str = "type"):
        self.name = name
        self.type_key = type_key
        self._entries: Dict[str, Tuple[type, type]] = {}

    def register(self, key: str, cls: type, config_cls: type):
        self._entries[key] = (cls, config_cls)
        return cls

    def keys(self):
        return list(self._entries)

    def get(self, key: str) -> Tuple[type, type]:
        if key not in self._entries:
            raise KeyError(f"Unknown {self.name} '{key}'. "
                           f"Registered: {sorted(self._entries)}")
        return self._entries[key]

    def load(self, config: Any, **kwargs):
        """Instantiates the implementation selected by the config."""
        if config is None:
            return None
        if dataclasses.is_dataclass(config):
            config = to_dict(config)
        if self.type_key not in config or config[self.type_key] in (None, MISSING):
            raise KeyError(f"Config for {self.name} misses its discriminator "
                           f"field '{self.type_key}': {config}")
        key = config[self.type_key]
        if key == "none":
            return None
        cls, config_cls = self.get(key)
        return cls(dataclass_from_dict(config_cls, config), **kwargs)
