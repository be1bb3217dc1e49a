"""A minimal yacs-compatible config node.

The reference uses yacs 0.1.6 (`configs/defaults.py:1`,
`requirements.txt`); yacs is not available here, so this module provides
the subset of its surface the framework needs: attribute access, YAML
merge (`merge_from_file`), dotted-list merge (`merge_from_list`),
`freeze`/`defrost`, `clone`, and YAML dump.

`yaml` is imported only inside `merge_from_file` and `dump`, so a config
built in code needs no YAML package.
"""

from __future__ import annotations

import ast
import copy
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
        import yaml

        with open(yaml_path, "r", encoding="utf-8") as f:
            other = yaml.safe_load(f.read()) or {}
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
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

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
