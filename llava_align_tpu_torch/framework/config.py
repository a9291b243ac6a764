"""YAML config system with dot-list CLI overrides (a copy of
llava_align_tpu/framework/config.py; tests/test_torch_copies.py holds
_parse_value, set_dot, get_dot and merge to the original's source). Unlike
the original, yaml is imported where a file is read or written, so the
module imports without PyYAML.

Capability parity: reference experiments/lavis/common/config.py:16-128
(OmegaConf YAML + `--options a.b=c` dot-list merge + run/model/dataset
sections + validation). Implemented on plain yaml + nested dicts — no
omegaconf in the image.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional, Sequence


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except (ValueError, TypeError):
        return text


def set_dot(d: Dict[str, Any], dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
        if not isinstance(cur, dict):
            raise TypeError(f"cannot descend into non-dict at {k} of {dotted_key}")
    cur[keys[-1]] = value


def get_dot(d: Dict[str, Any], dotted_key: str, default: Any = None) -> Any:
    cur: Any = d
    for k in dotted_key.split("."):
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """Load a YAML file, apply `a.b.c=value` dot-list options, expose the
    run/model/datasets sections (reference config.py:16-60)."""

    def __init__(
        self,
        cfg_path: Optional[str] = None,
        options: Optional[Sequence[str]] = None,
        defaults: Optional[Dict[str, Any]] = None,
    ):
        cfg: Dict[str, Any] = copy.deepcopy(defaults) if defaults else {}
        if cfg_path:
            import yaml

            with open(cfg_path) as f:
                loaded = yaml.safe_load(f) or {}
            cfg = merge(cfg, loaded)
        for opt in options or []:
            if "=" not in opt:
                raise ValueError(f"override must be key=value, got {opt!r}")
            key, val = opt.split("=", 1)
            set_dot(cfg, key.strip(), _parse_value(val.strip()))
        self._cfg = cfg

    @property
    def run_cfg(self) -> Dict[str, Any]:
        return self._cfg.get("run", {})

    @property
    def model_cfg(self) -> Dict[str, Any]:
        return self._cfg.get("model", {})

    @property
    def datasets_cfg(self) -> Dict[str, Any]:
        return self._cfg.get("datasets", {})

    def get(self, dotted_key: str, default: Any = None) -> Any:
        return get_dot(self._cfg, dotted_key, default)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg)

    def pretty(self) -> str:
        import yaml

        return yaml.safe_dump(self._cfg, sort_keys=True)

    def validate(self, required: Sequence[str]) -> None:
        missing = [k for k in required if self.get(k) is None]
        if missing:
            raise ValueError(f"missing required config keys: {missing}")
