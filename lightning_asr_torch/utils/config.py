"""Hydra-style YAML config with dotted CLI overrides and ``${...}``
interpolation (port of ``lightning_asr_tpu/utils/config.py``).

  * ``load_config("conf/conf.yaml", overrides=["a.b=1"])``;
  * attribute and item access (``cfg.train.learning_rate``, ``cfg["train"]``)
    and dotted ``get`` / ``set``;
  * ``${path.to.key}`` interpolation and hydra's ``${now:%Y-%m-%d}``;
  * a ``defaults:`` list naming sibling YAML groups (``- log: hypra_logger``
    loads ``conf/log/hypra_logger.yaml`` under the key ``log``).

Files and override values are read by ``utils/yaml_subset.py``, which gives
what ``yaml.safe_load`` gives on the repository's ``conf/`` files; an
override value that is a string of a number (``1e-3``) becomes that number,
as hydra reads it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

from .yaml_subset import safe_load

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """A dict with attribute access, recursive over nested mappings."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def get(self, key: str, default: Any = None) -> Any:  # dotted get
        node: Any = self
        for part in key.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, key: str, value: Any) -> None:  # dotted set
        parts = key.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, ensure_ascii=False, default=str)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _load_yaml(path: Union[str, Path]) -> Any:
    return safe_load(Path(path).read_text(encoding="utf-8"))


def _parse_value(text: str) -> Any:
    """An override value: YAML, then a numeric string as its number."""
    try:
        value = safe_load(text)
    except ValueError:
        return text
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


def parse_overrides(args: Iterable[str]) -> List[Tuple[str, Any]]:
    """Parse ``key.path=value`` CLI override tokens."""
    out = []
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override {arg!r} is not of the form key=value")
        key, _, value = arg.partition("=")
        out.append((key.strip(), _parse_value(value)))
    return out


def _resolve_interpolations(cfg: Config) -> None:
    """Resolve ``${a.b}`` against the root config in place; every
    ``${now:...}`` of one pass shares one instant."""
    import datetime

    now = datetime.datetime.now()

    def lookup(name: str, depth: int) -> Any:
        if name.startswith("now:"):
            return now.strftime(name[4:])
        return resolve(cfg.get(name), depth)

    def resolve(val: Any, depth: int = 0) -> Any:
        if depth > 10:
            raise ValueError("interpolation depth exceeded (cycle?)")
        if isinstance(val, str):
            m = _INTERP.fullmatch(val.strip())
            if m:                                    # a whole-string reference keeps its type
                return lookup(m.group(1), depth + 1)

            def sub(mm: re.Match) -> str:
                ref = lookup(mm.group(1), depth + 1)
                return "" if ref is None else str(ref)

            return _INTERP.sub(sub, val)
        return val

    def walk(node: Any) -> Any:
        if isinstance(node, Config):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(x) for x in node]
        return resolve(node)

    walk(cfg)


def load_config(path: Union[str, Path], overrides: Optional[Iterable[str]] = None,
                resolve: bool = True) -> Config:
    """Load a YAML config, apply its ``defaults:`` groups and the CLI
    overrides, then resolve interpolations."""
    path = Path(path)
    cfg = Config(_load_yaml(path) or {})
    defaults = cfg.pop("defaults", None)
    for entry in defaults or []:
        if isinstance(entry, Mapping):
            for group, name in entry.items():
                cfg[str(group)] = _wrap(_load_yaml(path.parent / str(group) / f"{name}.yaml") or {})
        elif isinstance(entry, str) and entry != "_self_":
            for k, v in (_load_yaml(path.parent / f"{entry}.yaml") or {}).items():
                cfg.setdefault(k, _wrap(v))
    for key, value in parse_overrides(overrides or []):
        cfg.set(key, value)
    if resolve:
        _resolve_interpolations(cfg)
    return cfg


def config_from_dict(d: Mapping[str, Any]) -> Config:
    return Config(d)


def config_hash(cfg: Config) -> str:
    """The first 12 hex digits of the sha256 of the config's JSON, keys
    sorted (the JAX package's run identity)."""
    import hashlib

    text = json.dumps(cfg.to_dict(), sort_keys=True, default=str)
    return hashlib.sha256(text.encode()).hexdigest()[:12]
