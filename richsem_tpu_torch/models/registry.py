"""Model registry: a decorator maps a model name to its build function
(counterpart of ``richsem_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        if name in MODEL_REGISTRY:
            raise KeyError(f"model {name!r} already registered")
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def build_model(name: str, *args, **kwargs):
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name](*args, **kwargs)
