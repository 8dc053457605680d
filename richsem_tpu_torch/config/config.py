"""Python-file configuration system.

A copy of ``richsem_tpu/config/config.py`` (which is already free of JAX), so
that the PyTorch port reads ``configs/richsem/*.py`` without importing the
JAX package.

Capability parity with the reference's ``util/slconfig.py`` (SLConfig:
python-file configs, ``_base_`` list inheritance with ``_delete_`` keys,
dotted-key overrides) — re-implemented without the addict/yapf dependencies.
A config is a plain nested :class:`Config` (attribute-access dict); configs
are ordinary python files whose module-level names become keys.

Reference behavior mirrored:
  - ``_base_``: str or list of paths relative to the config file; bases are
    merged in order, later files and the leaf file win
    (reference util/slconfig.py:112-142).
  - ``_delete_``: a dict value containing ``_delete_=True`` replaces the base
    dict instead of merging into it (reference util/slconfig.py:16-17).
  - ``merge_from_dict``: dotted keys (``a.b.c=v``) deep-merge into the tree
    (reference util/slconfig.py:360-390).
  - ``parse_override_options``: ``k=v`` CLI strings with int/float/bool/None
    coercion and comma-separated lists (reference util/slconfig.py:403-435,
    DictAction).
"""

from __future__ import annotations

import ast
import copy
import json
import os
import types
from typing import Any, Dict, Iterable, List, Optional

_RESERVED = ("_base_", "_delete_")


class Config(dict):
    """A dict with attribute access. Missing attribute access raises."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        out = Config()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls._wrap(dict(d))

    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        """Load a python config file, resolving ``_base_`` inheritance."""
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith(".py"):
            raise ValueError(f"only .py configs are supported, got {filename}")

        namespace = _exec_config_file(filename)
        leaf = {
            k: v
            for k, v in namespace.items()
            if not k.startswith("__") and not _is_module_or_fn(v)
        }

        cfg = cls()
        base = leaf.pop("_base_", None)
        if base is not None:
            if isinstance(base, str):
                base = [base]
            for base_path in base:
                base_cfg = cls.fromfile(
                    os.path.join(os.path.dirname(filename), base_path)
                )
                cfg = _merge(cfg, base_cfg)
        cfg = _merge(cfg, cls._wrap(leaf))
        return cfg

    # ------------------------------------------------------------------
    # merge / override
    # ------------------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Deep-merge dotted-key options, e.g. ``{"a.b": 1}``."""
        tree: Config = Config()
        for full_key, value in options.items():
            node = tree
            parts = full_key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, Config())
            node[parts[-1]] = Config._wrap(value)
        merged = _merge(self, tree)
        self.clear()
        self.update(merged)

    # ------------------------------------------------------------------
    # io
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self.items()}

    def dump(self, path: str) -> None:
        """Dump as JSON (round-trippable via :meth:`from_dict`)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=repr)


def _is_module_or_fn(v: Any) -> bool:
    return isinstance(v, (types.ModuleType, types.FunctionType, type))


def _exec_config_file(filename: str) -> Dict[str, Any]:
    with open(filename) as f:
        source = f.read()
    # Validate syntax with a clear error before exec.
    ast.parse(source, filename=filename)
    namespace: Dict[str, Any] = {"__file__": filename}
    code = compile(source, filename, "exec")
    exec(code, namespace)  # noqa: S102 - python-file configs by design
    return namespace


def _merge(base: Any, override: Any) -> Any:
    """Merge ``override`` onto ``base``; override wins. ``_delete_`` replaces."""
    if isinstance(override, dict):
        if override.get("_delete_", False):
            return Config._wrap(
                {k: v for k, v in override.items() if k not in _RESERVED}
            )
        if not isinstance(base, dict):
            base = Config()
        out = Config(base)
        for k, v in override.items():
            if k in _RESERVED:
                continue
            out[k] = _merge(out.get(k), v)
        return out
    return copy.deepcopy(override)


# ----------------------------------------------------------------------
# CLI override parsing (reference DictAction semantics)
# ----------------------------------------------------------------------
def _coerce(value: str) -> Any:
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    lowered = value.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    return value


def parse_override_options(pairs: Optional[Iterable[str]]) -> Dict[str, Any]:
    """Parse ``["k=v", "a.b=1,2"]`` CLI strings into an override dict."""
    options: Dict[str, Any] = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError(f"override option must be key=value, got {pair!r}")
        key, raw = pair.split("=", 1)
        vals: List[Any] = [_coerce(v) for v in raw.split(",")]
        options[key.strip()] = vals[0] if len(vals) == 1 else vals
    return options
