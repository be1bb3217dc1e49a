"""A minimal yacs-compatible config node.

The reference uses yacs 0.1.6 (`configs/defaults.py:1`,
`requirements.txt`); yacs is not available here, so this module provides
the subset of its surface the framework needs: attribute access, YAML
merge (`merge_from_file`), dotted-list merge (`merge_from_list`),
`freeze`/`defrost`, `clone`, and YAML dump.

No YAML package is needed: `parse_config_text` reads the subset of YAML
that the repo's config files use, and `dump` writes it (see
`parse_config_text` for the subset). Anything outside it raises
`ConfigSyntaxError`, naming the file and line; the reader never guesses
what an ambiguous scalar means. `dump` writes what `yaml.safe_dump(...,
sort_keys=False)` writes for such a tree, and the reader reads it back.
"""

from __future__ import annotations

import ast
import copy
import math
import re
from typing import Any

_FROZEN = "__frozen__"


class CfgNode(dict):
    """Dict with attribute access, freezing, and recursive YAML merging."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set {name!r} on a frozen CfgNode")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set {key!r} on a frozen CfgNode")
        super().__setitem__(key, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, yaml_path: str) -> None:
        with open(yaml_path, "r", encoding="utf-8") as f:
            other = parse_config_text(f.read(), yaml_path)
        self._merge_dict(other)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key,value pairs: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf])

    def _merge_dict(self, other: dict) -> None:
        frozen = self.is_frozen()
        if frozen:
            self.defrost()
        try:
            for k, v in other.items():
                if k not in self:
                    raise KeyError(f"Non-existent config key: {k}")
                if isinstance(v, dict):
                    if not isinstance(self[k], CfgNode):
                        raise TypeError(f"Cannot merge dict into leaf key {k}")
                    self[k]._merge_dict(v)
                else:
                    self[k] = _check_type(v, self[k], k)
        finally:
            if frozen:
                self.freeze()

    # -- dumping -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return dump_config_text(self.to_dict())

    def __str__(self) -> str:  # match yacs logging style
        return self.dump()


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a CLI-string override to the type of the existing value.

    Like yacs (`yacs/config.py _decode_cfg_value`): ast.literal_eval, not
    yaml — PyYAML's float resolver rejects bare scientific notation
    ('5e-4' would stay a string and raise TypeError against a float slot)
    and its 1.1 bool resolver turns 'NO'/'on' into bools."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # genuine string override
    return _check_type(value, old, "<cli>")


def _check_type(new: Any, old: Any, key: str) -> Any:
    if old is None or new is None:
        return new
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, str) and isinstance(new, bool):
        # tri-state knobs documented as "auto" | True | False (MODEL.REMAT,
        # MODEL.FUSED_MLP): a YAML `REMAT: true` (or unquoted on/off, which
        # PyYAML 1.1 parses as bool) and the CLI override `MODEL.REMAT True`
        # must merge into the "auto" string default; the _resolve_* policies
        # accept bools directly.
        return new
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return type(old)(new)
    if not isinstance(new, type(old)) and not isinstance(old, type(new)):
        raise TypeError(
            f"Type mismatch for key {key}: {type(old).__name__} vs {type(new).__name__}"
        )
    return new


# ---- the YAML subset of the config files ------------------------------------
class ConfigSyntaxError(ValueError):
    """A config file holds something outside the subset `parse_config_text`
    reads."""


_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?=\s|$)")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
# YAML 1.1's float needs a dot; '5e-4' would be a string to PyYAML
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*(?: [A-Za-z0-9_./-]+)*")
_TRUE = ("true", "True", "TRUE")
_FALSE = ("false", "False", "FALSE")
# scalars PyYAML would turn into bools or nulls: quote them to mean a string
_AMBIGUOUS = ("yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF",
              "~", "null", "Null", "NULL")


def _resolve_plain(text: str, where: str):
    """The value of an unquoted scalar, or ConfigSyntaxError."""
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text in _AMBIGUOUS:
        raise ConfigSyntaxError(f"{where}: {text!r} is ambiguous (a bool or null to YAML); quote it")
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _PLAIN.fullmatch(text):
        return text
    raise ConfigSyntaxError(f"{where}: unsupported scalar {text!r} (quote a string; write a "
                            "float with a dot and a signed exponent, e.g. 1.0e-05)")


def _after_value(rest: str, where: str) -> None:
    rest = rest.lstrip()
    if rest and not rest.startswith("#"):
        raise ConfigSyntaxError(f"{where}: unexpected text after the value: {rest!r}")


def _quoted(s: str, where: str) -> tuple[str, str]:
    """A quoted scalar at the start of ``s``: (its value, the rest)."""
    q = s[0]
    if q == '"':
        end = s.find('"', 1)
        if end < 0:
            raise ConfigSyntaxError(f"{where}: unterminated double-quoted string")
        if "\\" in s[1:end]:
            raise ConfigSyntaxError(f"{where}: escapes in double-quoted strings are not supported")
        return s[1:end], s[end + 1:]
    out, i = [], 1
    while True:
        end = s.find("'", i)
        if end < 0:
            raise ConfigSyntaxError(f"{where}: unterminated single-quoted string")
        out.append(s[i:end])
        if s[end + 1:end + 2] != "'":
            return "".join(out), s[end + 1:]
        out.append("'")
        i = end + 2


def _flow_list(s: str, where: str) -> tuple[list, str]:
    """A flow list of scalars at the start of ``s``: (its items, the rest)."""
    items, s = [], s[1:].lstrip()
    if s.startswith("]"):
        return items, s[1:]
    while True:
        if not s or s[0] in "[]{},#":
            raise ConfigSyntaxError(f"{where}: unsupported flow list (scalars only, no trailing comma)")
        if s[0] in "'\"":
            value, s = _quoted(s, where)
        else:
            m = re.match(r"[^,\]#]*", s)
            value, s = _resolve_plain(m.group(0).rstrip(), where), s[m.end():]
        items.append(value)
        s = s.lstrip()
        if s.startswith("]"):
            return items, s[1:]
        if not s.startswith(","):
            raise ConfigSyntaxError(f"{where}: unterminated flow list")
        s = s[1:].lstrip()


_EMPTY = object()  # a key whose value is the indented block below it


def _value(s: str, where: str):
    """The value written after ``key:`` or ``- ``: a scalar, a flow list or
    _EMPTY (nothing but maybe a comment)."""
    s = s.strip()
    if not s or s.startswith("#"):
        return _EMPTY
    if s[0] in "'\"":
        value, rest = _quoted(s, where)
    elif s[0] == "[":
        value, rest = _flow_list(s, where)
    elif s[0] in "{&*!|>%@`?:,]}":
        raise ConfigSyntaxError(f"{where}: unsupported YAML construct {s!r}")
    else:
        cut = re.search(r"\s#", s)
        value, rest = _resolve_plain((s[:cut.start()] if cut else s).rstrip(), where), ""
    _after_value(rest, where)
    return value


def parse_config_text(text: str, path: str = "<string>") -> dict:
    """The mapping a config file holds, read without a YAML package.

    The subset: nested mappings by indentation (spaces only; keys are
    identifiers), ``#`` comments, plain / single-quoted / double-quoted
    (no escapes) strings, ints, floats with a dot (YAML 1.1), the bools
    true/True/TRUE and false/False/FALSE, flow lists of scalars (``[]``,
    ``[0.1, 0.2, 0.3]``) and block lists of scalars (``- 0.1`` lines, as
    `dump_config_text` writes them). Within it the result equals
    ``yaml.safe_load(text)``; anything else (anchors, flow mappings, nulls,
    yes/no/on/off, '5e-4', duplicate keys, a key with no value, tabs, ...)
    raises ConfigSyntaxError naming ``path`` and the line."""
    root: dict = {}
    stack: list = [(0, root)]  # (indent, dict or list) of the open blocks
    pending = None             # (dict, key, indent) of a key awaiting its block
    for lineno, line in enumerate(text.splitlines(), 1):
        where = f"{path}:{lineno}"
        body = line.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        indent = len(line) - len(body)
        if body[0] == "\t" or body.startswith(("---", "...")):
            raise ConfigSyntaxError(f"{where}: tabs and document markers are not supported")
        is_item = body == "-" or body.startswith("- ")
        if pending is not None:
            parent, key, key_indent = pending
            pending = None
            if is_item and indent >= key_indent:
                parent[key] = []
            elif not is_item and indent > key_indent:
                parent[key] = {}
            else:
                raise ConfigSyntaxError(f"{path}:{lineno - 1}: key {key!r} has no value")
            stack.append((indent, parent[key]))
        while indent < stack[-1][0] or (
                indent == stack[-1][0] and not is_item and isinstance(stack[-1][1], list)):
            stack.pop()
        block_indent, block = stack[-1]
        if indent != block_indent:
            raise ConfigSyntaxError(f"{where}: bad indentation")
        if is_item:
            if not isinstance(block, list):
                raise ConfigSyntaxError(f"{where}: a list item where a mapping key belongs")
            value = _value(body[1:], where)
            if value is _EMPTY or isinstance(value, list):
                raise ConfigSyntaxError(f"{where}: list items must be scalars")
            block.append(value)
            continue
        m = _KEY.match(body)
        if m is None or isinstance(block, list):
            raise ConfigSyntaxError(f"{where}: expected 'KEY: value' (keys are identifiers)")
        key = m.group(1)
        if key in block:
            raise ConfigSyntaxError(f"{where}: duplicate key {key!r}")
        value = _value(body[m.end():], where)
        if value is _EMPTY:
            pending = (block, key, indent)
        else:
            block[key] = value
    if pending is not None:
        raise ConfigSyntaxError(f"{path}: key {pending[1]!r} has no value")
    return root


def _dump_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"cannot dump the non-finite float {v}")
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        try:
            plain = _resolve_plain(v, "") == v
        except ConfigSyntaxError:
            plain = False
        if plain:
            return v
        if any(ord(c) < 32 for c in v):
            raise ValueError(f"cannot dump the string {v!r}: control characters")
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot dump a {type(v).__name__} config value: {v!r}")


def dump_config_text(tree: dict, indent: int = 0) -> str:
    """The text of a config tree in the subset `parse_config_text` reads."""
    pad = " " * indent
    out = []
    for k, v in tree.items():
        if not (isinstance(k, str) and _KEY.fullmatch(k + ":")):
            raise ValueError(f"cannot dump the config key {k!r}")
        if isinstance(v, dict):
            if not v:
                raise ValueError(f"cannot dump the empty mapping {k!r}")
            out.append(f"{pad}{k}:\n" + dump_config_text(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}: []\n" if not v else
                       f"{pad}{k}:\n" + "".join(f"{pad}- {_dump_scalar(x)}\n" for x in v))
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)
